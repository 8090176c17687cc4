"""The port's main path as a whole, and the server, against the JAX flow.

fit_chunked_many -> ckpt.save -> BankServer.from_checkpoint -> ragged
serving -> swap_bank runs through both packages on the same seeded numpy
data (the port on the CPU). The trained banks agree within the engine
tolerance and the served class ids exactly. The port imports neither JAX
nor the JAX package.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import fit_chunked_many as j_fit_chunked_many
from repro.serve import BankServer as JBankServer
from repro_torch.checkpoint import ckpt
from repro_torch.core import (
    StreamCheckpoint,
    accuracy,
    fit_c_grid,
    fit_chunked_many,
    fit_ovr,
    ovr_signs,
    predict,
    predict_c_grid,
    predict_ovr,
)
from repro_torch.serve import BankServer

N_CLASSES, C_PTS, D = 8, (1.0, 10.0, 100.0), 16
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _blobs(n, seed, proto_seed=0):
    proto = (np.random.default_rng(proto_seed).normal(size=(N_CLASSES, D)) * 3).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, size=n)
    X = (rng.normal(size=(n, D)) + proto[labels]).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X, labels


def _signs(labels):
    return np.tile(ovr_signs(labels, N_CLASSES, device="cpu").numpy(), (len(C_PTS), 1))


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    """Both packages trained on the same chunks, checkpointed and served."""
    Xtr, ytr = _blobs(600, seed=0)
    Xte, _ = _blobs(150, seed=1)
    Y = _signs(ytr)
    cs = np.repeat(np.asarray(C_PTS, np.float32), N_CLASSES)
    chunks = [(Xtr[lo : lo + 200], Y[:, lo : lo + 200]) for lo in range(0, 600, 200)]
    out = {}
    for name, fit, save, server_cls, kw in (
        ("jax", j_fit_chunked_many, jckpt.save, JBankServer, {}),
        ("port", fit_chunked_many, ckpt.save, BankServer, {"device": "cpu"}),
    ):
        res = fit(chunks, cs, b_tile=8, block_n=64, **kw)
        path = str(tmp_path_factory.mktemp(name))
        save(path, res.ball, meta={"position": res.position, "n_classes": N_CLASSES})
        server = server_cls.from_checkpoint(path, epilogue="ovr", q_block=64, b_tile=16, **kw)
        rng = np.random.default_rng(3)
        reqs, lo = [], 0
        while lo < len(Xte):
            m = int(rng.integers(1, 40))
            reqs.append(server.submit(Xte[lo : lo + m]))
            lo += m
        server.run()
        out[name] = dict(res=res, path=path, server=server, reqs=reqs)
    out.update(Xte=Xte, cs=cs, chunks=chunks)
    return out


def test_trained_banks_agree(flows):
    jb, pb = flows["jax"]["res"].ball, flows["port"]["res"].ball
    assert flows["jax"]["res"].position == flows["port"]["res"].position == 600
    np.testing.assert_allclose(pb.w.numpy(), np.asarray(jb.w), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pb.r.numpy(), np.asarray(jb.r), rtol=1e-4)
    np.testing.assert_allclose(pb.xi2.numpy(), np.asarray(jb.xi2), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(pb.m.numpy(), np.asarray(jb.m))


def test_served_ids_agree_and_match_direct_readout(flows):
    cls = {k: np.concatenate([r.result[0] for r in flows[k]["reqs"]]) for k in ("jax", "port")}
    margin = {k: np.concatenate([r.result[1] for r in flows[k]["reqs"]]) for k in ("jax", "port")}
    np.testing.assert_array_equal(cls["port"], cls["jax"])
    np.testing.assert_allclose(margin["port"], margin["jax"], rtol=2e-4, atol=2e-5)
    rcls, rmargin = predict_c_grid(flows["port"]["res"].ball, flows["Xte"], N_CLASSES)
    np.testing.assert_array_equal(cls["port"], rcls.numpy())
    np.testing.assert_allclose(margin["port"], rmargin.numpy(), rtol=2e-4, atol=2e-5)


def test_server_stats_count_slots(flows):
    stats = flows["port"]["server"].stats
    assert stats.slot_busy_rows == 150
    assert stats.steps == 3 and stats.slot_idle_rows == 3 * 64 - 150
    assert stats.finished == stats.admitted == len(flows["port"]["reqs"])
    assert abs(stats.utilization - 150 / 192) < 1e-12


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_checkpoints_serve_across_packages(flows, reader):
    """The other package's checkpoint serves the same ids."""
    writer = "port" if reader == "jax" else "jax"
    Xq = flows["Xte"][:64]
    if reader == "port":
        server = BankServer.from_checkpoint(flows[writer]["path"], epilogue="ovr", device="cpu")
    else:
        server = JBankServer.from_checkpoint(flows[writer]["path"], epilogue="ovr")
    assert server.n_classes == N_CLASSES and server.bank_shape == (24, D)
    cls, _ = server.score(Xq)
    own = flows[writer]["server"].score(Xq)[0]
    np.testing.assert_array_equal(np.asarray(cls), np.asarray(own))


def test_swap_bank_keeps_queued_requests(flows):
    Xte, cs = flows["Xte"], flows["cs"]
    res = flows["port"]["res"]
    more = [(Xte[:100], _signs(np.argmax(predict_ovr(res.ball, Xte[:100]).numpy()[:, None]
                                         == np.arange(N_CLASSES), axis=1)))]
    res2 = fit_chunked_many(more, cs, resume=res, b_tile=8, block_n=64)
    assert res2.position == 700
    server = BankServer(res.ball, epilogue="scores", q_block=32)
    reqs = [server.submit(Xte[lo : lo + 16]) for lo in range(0, 64, 16)]
    server.step()  # the first 32 rows score on the old bank
    assert server.pending_rows() == 32
    server.swap_bank(res2.ball)
    server.run()
    old = (torch.from_numpy(Xte[:32]) @ res.ball.w.T).numpy()
    new = (torch.from_numpy(Xte[32:64]) @ res2.ball.w.T).numpy()
    got = np.concatenate([r.result for r in reqs])
    np.testing.assert_allclose(got[:32], old, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got[32:], new, rtol=2e-4, atol=2e-5)
    assert server.stats.bank_swaps == 1 and all(r.done for r in reqs)
    with pytest.raises(ValueError, match="hot-swap bank shape"):
        server.swap_bank(res.ball.w[:3])


def test_topk_server_and_empty_request():
    rng = np.random.default_rng(5)
    W = rng.normal(size=(10, 4)).astype(np.float32)
    server = BankServer(torch.from_numpy(W), epilogue="topk", k=3, q_block=8)
    empty = server.submit(np.zeros((0, 4), np.float32))
    assert empty.done and server.stats.finished == 1
    Xq = rng.normal(size=(11, 4)).astype(np.float32)
    vals, ids = server.score(Xq)
    want = np.argsort(-(Xq @ W.T), axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(ids, want)
    assert vals.shape == (11, 3)


def test_checkpoint_callback_and_resume_match_one_pass(flows):
    seen = []
    full = fit_chunked_many(flows["chunks"], flows["cs"], b_tile=8, block_n=64, device="cpu",
                            checkpoint_every=200, checkpoint_cb=seen.append)
    assert [c.position for c in seen] == [200, 400, 600]
    resumed = fit_chunked_many(flows["chunks"][1:], flows["cs"], b_tile=8, block_n=64,
                               resume=StreamCheckpoint(seen[0].ball, seen[0].position))
    assert resumed.position == 600
    for a, b in zip(full.ball, resumed.ball):
        assert torch.equal(a, b)


def test_fit_ovr_and_c_grid_match_the_bank(flows):
    Xtr, ytr = _blobs(300, seed=4)
    ovr = fit_ovr(Xtr, ytr, N_CLASSES, 10.0, b_tile=8, device="cpu")
    assert ovr.w.shape == (N_CLASSES, D)
    assert (predict_ovr(ovr, Xtr).numpy() == ytr).mean() > 0.5
    y = np.where(ytr == 0, 1.0, -1.0).astype(np.float32)
    grid = fit_c_grid(Xtr, y, np.asarray(C_PTS, np.float32), device="cpu")
    one = fit_ovr(Xtr, (ytr != 0).astype(np.int64), 2, 10.0, device="cpu")
    assert torch.allclose(grid.w[1], one.w[0])  # class 0 is the "+1" lane of label 0
    ball = type(grid)(*(x[1] for x in grid))
    acc = accuracy(ball, Xtr, y).item()
    assert acc == pytest.approx(float((predict(ball, Xtr).numpy() == y).mean()))
    # fit_ovr(lookahead=4) runs Algorithm 2 (kernel B3's path) at the bank's
    # shape and separates the training classes; the per-model scan engine
    # (kernel B4's path) gives the one-pass grid's bank, m exact.
    la = fit_ovr(Xtr, ytr, N_CLASSES, 10.0, lookahead=4, device="cpu")
    assert la.w.shape == ovr.w.shape and (predict_ovr(la, Xtr).numpy() == ytr).mean() > 0.5
    scan = fit_c_grid(Xtr, y, np.asarray(C_PTS, np.float32), engine="scan", device="cpu")
    torch.testing.assert_close(scan.w, grid.w, rtol=2e-4, atol=2e-5)
    assert torch.equal(scan.m, grid.m)


def test_unported_banks_and_checkpoints_raise(tmp_path):
    class KernelBankLike:
        points = coef = None

    # Kernel banks are served now (tests/test_torch_kernel_bank.py); what is
    # still refused names its ROADMAP item or the argument that is missing.
    with pytest.raises(ValueError, match="kernel="):
        BankServer(KernelBankLike(), device="cpu")
    with pytest.raises(ValueError, match="only applies to a KernelBank"):
        BankServer(torch.zeros(4, 3), kernel="rbf")
    # bank_resident="hbm" serves through B6 (the ring), with the bits of "vmem".
    w = torch.arange(12.0).reshape(4, 3)
    q = np.ones((5, 3), np.float32)
    np.testing.assert_array_equal(BankServer(w, bank_resident="hbm").score(q),
                                  BankServer(w, bank_resident="vmem").score(q))
    ckpt.save(str(tmp_path), (torch.zeros(2),), meta={"live_k": 2})
    with pytest.raises(NotImplementedError, match="A11"):
        BankServer.from_checkpoint(str(tmp_path), device="cpu")
    ckpt.save(str(tmp_path), (torch.zeros(2),), meta={"bank_kind": "kernel"})
    with pytest.raises(ValueError, match="7-leaf"):
        BankServer.from_checkpoint(str(tmp_path), device="cpu")
    ckpt.save(str(tmp_path), (torch.zeros(2),), meta={})
    with pytest.raises(ValueError, match="4-leaf"):
        BankServer.from_checkpoint(str(tmp_path), device="cpu")


def test_port_imports_without_jax_or_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any import of jax now fails
        sys.path.insert(0, {SRC!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        assert len(names) >= 14, names
        print("ok", len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
