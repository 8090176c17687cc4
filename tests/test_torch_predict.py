"""B2 in the port: ops.predict_bank against the JAX reference.

The same seeded numpy queries and bank go through ``repro.kernels.ops.
predict_bank`` (Pallas in interpret mode), the einsum oracle
``repro.kernels.ref.predict_bank_ref`` and the port on the CPU, which runs
B2's plain version. Scores agree within the engine tolerance, ids exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import predict_bank_ref
from repro_torch.kernels import ops
from repro_torch.kernels.predict import (
    NEG_MASK,
    predict_bank_fused,
    predict_bank_plain,
)


def _data(q, b, d, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(q, d)).astype(np.float32),
        rng.normal(size=(b, d)).astype(np.float32),
    )


def _np(out):
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple) else (out,)))


def _assert_same(port, ref):
    for p, r in zip(_np(port), _np(ref)):
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, rtol=2e-4, atol=2e-5)


CASES = [
    # (Q, B, D, epilogue, extra, q_block, b_tile)
    (77, 13, 20, "scores", {}, 32, 8),                    # ragged Q and B
    (300, 24, 33, "scores", {}, 128, None),
    (77, 15, 20, "ovr", {"n_classes": 5}, 32, 16),       # classes padded to 8
    (100, 24, 12, "ovr", {"n_classes": 8}, 64, None),
    (77, 13, 20, "topk", {"k": 4}, 32, 8),                # running top-k across tiles
    (50, 40, 16, "topk", {"k": 40}, 64, 16),              # k = B
]


@pytest.mark.parametrize("q,b,d,epilogue,extra,q_block,b_tile", CASES)
def test_predict_bank_matches_jax_engine(q, b, d, epilogue, extra, q_block, b_tile):
    X, W = _data(q, b, d, seed=q + b + d)
    ref = jops.predict_bank(jnp.asarray(X), jnp.asarray(W), epilogue=epilogue,
                            q_block=q_block, b_tile=b_tile, **extra)
    port = ops.predict_bank(X, W, epilogue=epilogue, q_block=q_block, b_tile=b_tile,
                            device="cpu", **extra)
    _assert_same(port, ref)


@pytest.mark.parametrize("epilogue,extra", [
    ("scores", {}), ("ovr", {"n_classes": 7}), ("topk", {"k": 6}),
])
def test_predict_bank_matches_oracle(epilogue, extra):
    X, W = _data(61, 21, 10, seed=5)
    ref = predict_bank_ref(jnp.asarray(X), jnp.asarray(W), epilogue=epilogue, **extra)
    port = ops.predict_bank(torch.from_numpy(X), torch.from_numpy(W), epilogue=epilogue,
                            q_block=16, b_tile=8, **extra)
    _assert_same(port, ref)


def test_bf16_queries_match_jax_engine():
    X, W = _data(70, 16, 24, seed=8)
    ref = jops.predict_bank(jnp.asarray(X), jnp.asarray(W), q_block=32, stream_dtype="bf16")
    port = ops.predict_bank(X, W, q_block=32, stream_dtype="bf16", device="cpu")
    assert port.dtype == torch.float32
    _assert_same(port, ref)


def _assert_topk_ids(port, ref_vals, ref_ids, scores):
    """Values within the engine tolerance; ids equal wherever a value is
    separated from its neighbours by more than 1e-5 x max|score|."""
    vals, ids = (np.asarray(t) for t in port)
    np.testing.assert_allclose(vals, np.asarray(ref_vals), rtol=2e-4, atol=2e-5)
    tol = 1e-5 * np.abs(scores).max()
    gaps = np.diff(np.asarray(ref_vals), axis=1)
    sep = np.ones(vals.shape, bool)
    sep[:, 1:] &= -gaps > tol
    sep[:, :-1] &= -gaps > tol
    assert sep.mean() > 0.5
    np.testing.assert_array_equal(ids[sep], np.asarray(ref_ids)[sep])


@pytest.mark.parametrize("bank_resident", ["vmem", "hbm"])
def test_topk_past_the_shared_memory_lists_matches_jax_engine(bank_resident):
    """k = 728, one past what the kernels' shared-memory lists hold: the
    port serves it (the lists then live in the outputs) with the
    reference's ids, in both layouts."""
    X, W = _data(40, 1000, 16, seed=728)
    ref = jops.predict_bank(jnp.asarray(X), jnp.asarray(W), epilogue="topk", k=728, q_block=40)
    port = ops.predict_bank(X, W, epilogue="topk", k=728, q_block=40, bank_resident=bank_resident,
                            device="cpu")
    assert port[0].shape == (40, 728)
    _assert_topk_ids(port, *ref, X @ W.T)


@pytest.mark.parametrize("bank_resident", ["vmem", "hbm"])
def test_topk_of_the_whole_bank_with_ties_matches_reference(bank_resident):
    """k = B = 1,200 against the reference's oracle (``lax.top_k``), with
    exact ties from duplicated bank rows listed lowest lane first."""
    X, W = _data(30, 1200, 12, seed=12)
    W[900], W[1100], W[5] = W[3], W[3], W[640]
    ref = predict_bank_ref(jnp.asarray(X), jnp.asarray(W), epilogue="topk", k=1200)
    port = ops.predict_bank(X, W, epilogue="topk", k=1200, q_block=32, b_tile=256,
                            bank_resident=bank_resident, device="cpu")
    _assert_topk_ids(port, *ref, X @ W.T)
    vals, ids = (p.numpy() for p in port)
    for row in range(30):
        order = {int(i): p for p, i in enumerate(ids[row])}
        assert order[3] < order[900] < order[1100] and order[5] < order[640]
        assert vals[row, order[3]] == vals[row, order[1100]]
    assert sorted(ids[0].tolist()) == list(range(1200))


def test_ties_go_to_the_lowest_lane():
    """Duplicated bank rows tie exactly: ovr and topk pick the lower id, and
    topk lists the tied entries in id order."""
    X, W = _data(9, 8, 6, seed=3)
    W[5] = W[2]
    W[6] = W[2] * 100.0  # ... while model 6 dominates
    W[3] = W[6]
    cls, _ = ops.predict_bank(X, W, epilogue="ovr", n_classes=8, q_block=8, device="cpu")
    pos = X @ W[6] > 0
    assert (cls[:, 0].numpy()[pos] == 3).all()
    vals, ids = ops.predict_bank(X, W, epilogue="topk", k=8, q_block=8, device="cpu")
    v = vals.numpy()
    assert (np.diff(v, axis=1) <= 0).all()
    i = ids.numpy()
    for row in range(9):
        for a in range(7):
            if v[row, a] == v[row, a + 1]:
                assert i[row, a] < i[row, a + 1]


def test_scores_carry_no_bias_and_padding_never_wins():
    X, W = _data(8, 3, 4, seed=2)
    Q, Wt = torch.from_numpy(X), torch.from_numpy(W)
    Wp = torch.cat([Wt, torch.zeros(5, 4)])
    bias = torch.tensor([0.0] * 3 + [NEG_MASK] * 5)
    s = predict_bank_plain(Q, Wp, bias, q_block=8)
    assert torch.equal(s[:, 3:], torch.zeros(8, 5))
    vals, ids = predict_bank_plain(Q, Wp, bias, epilogue="topk", q_block=8, k=3)
    assert (ids < 3).all()


def test_fused_wrapper_runs_plain_version_on_cpu():
    X, W = _data(16, 8, 4, seed=6)
    Q, Wt, bias = torch.from_numpy(X), torch.from_numpy(W), torch.zeros(8)
    before = predict_bank_fused.launches
    got = predict_bank_fused(Q, Wt, bias, epilogue="ovr", q_block=16, nc_pad=8)
    want = predict_bank_plain(Q, Wt, bias, epilogue="ovr", q_block=16, nc_pad=8)
    assert predict_bank_fused.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw,err", [
    (dict(epilogue="nope"), ValueError),
    (dict(epilogue="ovr"), ValueError),                 # no n_classes
    (dict(epilogue="ovr", n_classes=3), ValueError),    # does not divide B=8
    (dict(epilogue="topk", k=9), ValueError),
    (dict(n_classes=4), ValueError),                    # n_classes without ovr
    (dict(k=2), ValueError),                            # k without topk
    (dict(bank_resident="hbm"), None),                  # B6: runs, as "vmem"
])
def test_bad_arguments_raise(kw, err):
    X, W = _data(4, 8, 3, seed=1)
    if err is None:
        got = ops.predict_bank(X, W, device="cpu", **kw)
        assert torch.equal(got, ops.predict_bank(X, W, device="cpu", bank_resident="vmem"))
        return
    with pytest.raises(err):
        ops.predict_bank(X, W, device="cpu", **kw)
