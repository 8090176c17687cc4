"""The LLM zoo's serving path on the port (repro_torch.configs, data.tokens,
models) against the JAX reference on the CPU.

Configs equal the reference's field for field; the token streams bit for
bit. Layers and models run on the same inputs (numpy seeds) with the
reference's parameters carried across by ``convert.lm_params_from_numpy``.

Tolerances, stated before the runs:
- f32 layers: rtol 1e-5 / atol 1e-5 x max|want| (the same f32 operations,
  other summation orders);
- f32 models (smoke configs as f32 copies): logits within 1e-4 x max|logit|
  of the reference's (prefill and five decode steps), ``loss`` within rtol
  1e-5;
- bf16 models (the smoke configs as published), fed the same tokens: each
  step's logits no farther from the reference's f32 run than twice the
  reference's own bf16 run is, plus 0.01 x max|logit|; within BF16_TOL x
  max|logit| of the reference's bf16 run (0.04 for the transformers; 0.3
  for xLSTM, whose mLSTM normalizer max(|n.q|, e^-m) cancels at random
  init: the reference's own bf16 run lies up to 0.44 x max|logit| from its
  f32 run there); and the greedy token equal wherever the reference's
  top-two logits part by more than twice BF16_TOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.data.tokens as rtok
import repro.models.layers as rl
import repro.models.xlstm as rx
from repro.models import build_model as ref_build

import repro_torch.configs as tcfg
import repro_torch.models.layers as tl
import repro_torch.models.xlstm as tx
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import styled_corpus, token_batches
from repro_torch.models import build_model

KEY = jax.random.PRNGKey(0)
F32_LOGIT_TOL = 1e-4
BF16_TOL = {"dense": 0.04, "vlm": 0.04, "moe": 0.04, "ssm": 0.3}


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rtol=1e-5, atol=1e-5):
    got, want = _np(got.float() if isinstance(got, torch.Tensor) else got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# configs and token streams
# ---------------------------------------------------------------------------


def test_archs_equal_the_reference():
    assert tcfg.list_archs() == rcfg.list_archs()


@pytest.mark.parametrize("arch", rcfg.list_archs())
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_the_reference(arch, smoke):
    got = tcfg.get_config(arch, smoke=smoke)
    want = rcfg.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.n_params(), got.active_params()) == (
        want.hd, want.n_params(), want.active_params())


def test_shapes_and_cells_equal_the_reference():
    for got, want in ((tcfg.SHAPES, rcfg.SHAPES), (tcfg.SMOKE_SHAPES, rcfg.SMOKE_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
            k: dataclasses.asdict(v) for k, v in want.items()}
    cfgs_t = [tcfg.get_config(a) for a in tcfg.list_archs()]
    cfgs_r = [rcfg.get_config(a) for a in rcfg.list_archs()]
    cells_t = [(c.name, s.name, ok, why) for c, s, ok, why in tcfg.cells(cfgs_t)]
    cells_r = [(c.name, s.name, ok, why) for c, s, ok, why in rcfg.cells(cfgs_r)]
    assert cells_t == cells_r


def test_token_batches_bit_equal():
    got = list(token_batches(300, 3, 17, 2, seed=5))
    want = list(rtok.token_batches(300, 3, 17, 2, seed=5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("tokens", "targets"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def test_styled_corpus_bit_equal():
    toks, labels = styled_corpus(512, 10, 33, seed=3)
    rt, rlab = rtok.styled_corpus(512, 10, 33, seed=3)
    assert toks.dtype == rt.dtype and np.array_equal(toks, rt)
    assert labels.dtype == rlab.dtype and np.array_equal(labels, rlab)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base,offset", [(1e4, 0), (1e6, 37)])
def test_rope_rotates_halves_as_the_reference(base, offset):
    x = np.random.default_rng(0).normal(size=(2, 11, 3, 16)).astype(np.float32)
    pos = np.arange(11) + offset
    _close(tl.rope(_t(x), torch.as_tensor(pos), base), rl.rope(jnp.asarray(x), jnp.asarray(pos), base))


def test_norms_equal_the_reference():
    rng = np.random.default_rng(1)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((3, 5, 32), (32,), (32,)))
    _close(tl.rmsnorm(_t(x), _t(w), 1e-5), rl.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(tl.layernorm(_t(x), _t(w), _t(b)),
           rl.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "sq_relu"])
def test_mlp_apply_per_kind(kind):
    rng = np.random.default_rng(2)
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w1", (32, 64)), ("w3", (32, 64)), ("w2", (64, 32)))}
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    got = tl.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), kind)
    want = rl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    _close(got, want)


ATTN_CASES = {
    # name: (H, KV, Sq, Sk, causal, window, q_offset, kv_valid_len, block_kv)
    "gqa_three_blocks": (4, 2, 24, 24, True, None, 0, None, 8),
    "window_padded_last_block": (4, 2, 20, 20, True, 5, 0, None, 8),
    "mqa_not_causal": (4, 1, 13, 13, False, None, 0, None, 13),
    "offset_valid_len_padded": (6, 2, 6, 24, True, None, 10, 16, 16),
    "window_offset_valid_len": (4, 4, 5, 40, True, 7, 20, 25, 16),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_equals_the_reference(case):
    H, KV, Sq, Sk, causal, window, q_offset, kv_valid, block = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, Sq, H, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sk, KV, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_valid_len=kv_valid,
              block_kv=block)
    got = tl.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = rl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(got, want)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("Sq,window", [(1, None), (1, 6), (3, 6)])
def test_direct_attention_equals_the_reference(Sq, window):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(window=window, q_offset=12, kv_valid_len=12 + Sq)
    _close(tl.direct_attention(_t(q), _t(k), _t(v), **kw),
           rl.direct_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def test_cross_entropy_with_ignored_targets():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 9, 50)) * 3).astype(np.float32)
    tgt = rng.integers(0, 50, (2, 9)).astype(np.int32)
    tgt[0, :4] = -1
    _close(tl.cross_entropy(_t(logits), torch.as_tensor(tgt)),
           rl.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt)))


def _gather_cross_entropy(logits, targets, ignore_index=-1):
    """The port's cross_entropy before its target logit became the one-hot
    contraction: a gather along the vocab."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.clamp(targets, min=0).long()
    picked = torch.gather(logits32, -1, tgt[..., None])[..., 0]
    mask = (targets != ignore_index).float()
    return ((lse - picked) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@pytest.mark.parametrize("shape,ignored,dtype", [
    ((2, 9, 50), 4, torch.float32), ((3, 17, 1000), 0, torch.float32),
    ((1, 33, 512), 33, torch.float32), ((2, 8, 256), 5, torch.bfloat16)])
def test_cross_entropy_one_hot_equals_the_gather_bit_for_bit(shape, ignored, dtype):
    """The one-hot contraction picks each target logit to the bit (x + 0 is
    x in f32), with ignored targets (-1) and with every target ignored, in
    f32 and from bf16 logits; and it stays within 1e-5 of the reference's."""
    rng = np.random.default_rng(sum(shape) + ignored)
    logits = (rng.normal(size=shape) * 4).astype(np.float32)
    tgt = rng.integers(0, shape[-1], shape[:-1]).astype(np.int64)
    tgt.reshape(-1)[:ignored] = -1
    lt, tt = torch.from_numpy(logits).to(dtype), torch.from_numpy(tgt)
    got = tl.cross_entropy(lt, tt)
    assert torch.equal(got, _gather_cross_entropy(lt, tt))
    want = rl.cross_entropy(jnp.asarray(lt.float().numpy()), jnp.asarray(tgt.astype(np.int32)))
    _close(got, want)


def _mlstm_inputs(seed, S=9, H=2, hd=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, S, H, hd)).astype(np.float32) for _ in range(3))
    i_pre, f_pre = (rng.normal(size=(2, S, H)).astype(np.float32) * 2 for _ in range(2))
    return q, k, v, i_pre, f_pre


def test_mlstm_parallel_equals_the_reference():
    args = _mlstm_inputs(6)
    _close(tx.mlstm_parallel(*map(_t, args)), jax.jit(rx.mlstm_parallel)(*map(jnp.asarray, args)))


def test_mlstm_step_chain_equals_the_reference():
    q, k, v, i_pre, f_pre = _mlstm_inputs(7, S=4)
    rng = np.random.default_rng(8)
    st = (rng.normal(size=(2, 2, 8, 8)).astype(np.float32),
          rng.normal(size=(2, 2, 8)).astype(np.float32), np.zeros((2, 2), np.float32))
    st_t, st_j = tuple(map(_t, st)), tuple(map(jnp.asarray, st))
    for t in range(4):
        step = [a[:, t] for a in (q, k, v, i_pre, f_pre)]
        y_t, st_t = tx.mlstm_step(st_t, *map(_t, step))
        y_j, st_j = rx.mlstm_step(st_j, *map(jnp.asarray, step))
        _close(y_t, y_j)
        for a, b in zip(st_t, st_j):
            _close(a, b)


def _jit_block(block):
    """The reference's block with 4 heads, jitted (eager JAX dispatches each
    step of its scans one by one)."""
    return jax.jit(lambda p, x, **kw: block(p, x, 4, **kw))


def _block_params(init, seed, d=32, H=4):
    p = init(jax.random.PRNGKey(seed), d, H, jnp.float32)
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) + (rng.normal(size=v.shape).astype(np.float32) * 0.1
                             if k in ("ln", "conv_b", "bias") else 0.0) for k, v in p.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("stateful", [False, True])
def test_mlstm_block_equals_the_reference(stateful):
    pj, pt = _block_params(rx.mlstm_init, 9)
    x = np.random.default_rng(10).normal(size=(2, 7, 32)).astype(np.float32)
    if stateful:  # the recurrence from a state and a conv history (prefill / decode)
        rng = np.random.default_rng(11)
        st = (rng.normal(size=(2, 4, 16, 16)).astype(np.float32) * 0.1,
              rng.normal(size=(2, 4, 16)).astype(np.float32) * 0.1,
              np.zeros((2, 4), np.float32))
        conv = rng.normal(size=(2, 3, 64)).astype(np.float32)
        yj, (sj, cj) = _jit_block(rx.mlstm_block)(pj, jnp.asarray(x), state=tuple(
            map(jnp.asarray, st)), conv_state=jnp.asarray(conv))
        yt, (s_t, ct) = tx.mlstm_block(pt, _t(x), 4, state=tuple(map(_t, st)), conv_state=_t(conv))
        for a, b in zip(s_t, sj):
            _close(a, b)
        _close(ct, cj)
    else:  # the parallel stabilized form (no state, S > 1)
        yj, (sj, cj) = _jit_block(rx.mlstm_block)(pj, jnp.asarray(x))
        yt, (s_t, ct) = tx.mlstm_block(pt, _t(x), 4)
        assert sj is None and s_t is None
        _close(ct, cj)
    _close(yt, yj)


@pytest.mark.parametrize("stateful", [False, True])
def test_slstm_block_equals_the_reference(stateful):
    pj, pt = _block_params(rx.slstm_init, 12)
    x = np.random.default_rng(13).normal(size=(2, 6, 32)).astype(np.float32)
    st = None
    if stateful:
        rng = np.random.default_rng(14)
        st = (rng.normal(size=(2, 32)).astype(np.float32), np.abs(rng.normal(size=(2, 32))).astype(np.float32) + 1,
              rng.normal(size=(2, 4)).astype(np.float32), rng.normal(size=(2, 32)).astype(np.float32))
    yj, sj = _jit_block(rx.slstm_block)(
        pj, jnp.asarray(x), state=None if st is None else tuple(map(jnp.asarray, st)))
    yt, s_t = tx.slstm_block(pt, _t(x), 4, state=None if st is None else tuple(map(_t, st)))
    _close(yt, yj)
    for a, b in zip(s_t, sj):
        _close(a, b)


# ---------------------------------------------------------------------------
# models: prefill, five decode steps and loss against the reference
# ---------------------------------------------------------------------------

MODEL_ARCHS = ["internlm2-1.8b", "granite-34b", "gemma3-27b", "nemotron-4-340b",
               "llava-next-mistral-7b", "qwen3-moe-30b-a3b", "xlstm-125m"]
B, P, N_DEC = 2, 24, 5


def _configs(arch):
    return rcfg.get_config(arch, smoke=True), tcfg.get_config(arch, smoke=True)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, P + N_DEC + 1)).astype(np.int32)
    img = None
    if cfg.family == "vlm":
        img = (rng.normal(size=(B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, img


def _batch(toks, img, wrap):
    b = {"tokens": wrap(toks)}
    if img is not None:
        b["image_embeds"] = wrap(img)
    return b


def _run_reference(cfg, params, toks, img):
    """Prefill the first P tokens into a cache of P + N_DEC, then N_DEC
    decode steps fed the next tokens of ``toks`` (teacher forcing). Returns
    the logits of each step and the tokens fed."""
    model = ref_build(cfg)
    pf = jax.jit(lambda p, b: model.prefill(p, {**b, "max_len": P + N_DEC}))
    dec = jax.jit(model.decode_step)
    logits, cache = pf(params, _batch(toks[:, :P], img, jnp.asarray))
    out, fed = [_np(logits)], []
    for t in range(N_DEC):
        nxt = toks[:, P + t : P + t + 1]
        fed.append(nxt)
        logits, cache = dec(params, cache, jnp.asarray(nxt))
        out.append(_np(logits))
    return out, fed


def _run_port(cfg, params, toks, img, fed):
    model = build_model(cfg)
    logits, cache = model.prefill(params, {**_batch(toks[:, :P], img, torch.as_tensor),
                                           "max_len": P + N_DEC})
    out = [logits.float().numpy()]
    for nxt in fed:
        logits, cache = model.decode_step(params, cache, torch.as_tensor(nxt))
        out.append(logits.float().numpy())
    return out


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def zoo(request):
    """The reference's and the port's runs of one smoke architecture, f32
    and bf16, on the reference's parameters."""
    cfg_r, cfg_t = _configs(request.param)
    cfg_r32, cfg_t32 = _f32(cfg_r), _f32(cfg_t)
    toks, img = _inputs(cfg_r)
    params32 = jax.jit(ref_build(cfg_r32).init)(KEY)
    # the bf16 init is the f32 draws cast (init_dense casts its f32 normals)
    shapes16 = jax.eval_shape(ref_build(cfg_r).init, KEY)
    params16 = jax.tree.map(lambda a, s: a.astype(s.dtype), params32, shapes16)
    pt32 = lm_params_from_numpy(cfg_t32, jax.tree.map(np.asarray, params32), device="cpu")
    pt16 = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params16), device="cpu")
    out = {"arch": request.param, "family": cfg_r.family}
    out["ref32"], fed32 = _run_reference(cfg_r32, params32, toks, img)
    out["port32"] = _run_port(cfg_t32, pt32, toks, img, fed32)
    out["ref16"], fed16 = _run_reference(cfg_r, params16, toks, img)
    out["port16"] = _run_port(cfg_t, pt16, toks, img, fed16)
    lb = _batch(toks[:, :P], img, np.asarray)
    lb["targets"] = toks[:, 1 : P + 1]
    out["loss_ref"] = float(jax.jit(ref_build(cfg_r32).loss)(
        params32, {k: jnp.asarray(v) for k, v in lb.items()})[0])
    out["loss_port"] = float(build_model(cfg_t32).loss(pt32, lb)[0])
    return out


def _logits_close(got, want, tol):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, tol * scale)


def test_prefill_logits_f32(zoo):
    _logits_close(zoo["port32"][0], zoo["ref32"][0], F32_LOGIT_TOL)


def test_decode_logits_f32(zoo):
    assert len(zoo["port32"]) == N_DEC + 1
    for got, want in zip(zoo["port32"][1:], zoo["ref32"][1:]):
        _logits_close(got, want, F32_LOGIT_TOL)


def test_loss_f32(zoo):
    assert np.isfinite(zoo["loss_ref"])
    np.testing.assert_allclose(zoo["loss_port"], zoo["loss_ref"], rtol=1e-5)


def test_bf16_greedy_tokens(zoo):
    tol = BF16_TOL[zoo["family"]]
    compared = 0
    for got, want, want32, own in zip(zoo["port16"], zoo["ref16"], zoo["ref32"], zoo["ref16"]):
        scale = np.abs(want32).max()
        # as near the f32 reference as the reference's own bf16 run is
        assert np.abs(got - want32).max() <= 2 * np.abs(own - want32).max() + 0.01 * scale
        _logits_close(got, want, tol)
        top2 = np.sort(want, -1)[:, -2:]
        parts = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(want).max(-1)
        assert (got.argmax(-1)[parts] == want.argmax(-1)[parts]).all()
        compared += int(parts.sum())
    if zoo["family"] != "ssm":  # the transformers' margins part at some step
        assert compared > 0


def test_unrolled_stack_equals_the_scanned_stack():
    """DecoderLM with ``cfg.unrolled`` (a list of per-layer dicts) gives the
    stacked layout's bits on the same weights (the reference's unrolled
    stack does not trace under jit, so the port holds it to itself)."""
    cfg = _f32(tcfg.get_config("gemma3-27b", smoke=True))
    ucfg = dataclasses.replace(cfg, unrolled=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    uparams = {**params, "layers": [{k: {kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                                     else v[i] for k, v in params["layers"].items()}
                                    for i in range(cfg.n_layers)]}
    assert lm_params_to_numpy(uparams)["layers"][0].keys() == params["layers"].keys()
    toks, _ = _inputs(cfg)
    got = _run_port(ucfg, uparams, toks, None, [toks[:, P + t : P + t + 1] for t in range(N_DEC)])
    want = _run_port(cfg, params, toks, None, [toks[:, P + t : P + t + 1] for t in range(N_DEC)])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# the converter (Zamba2's and Whisper's trees: tests/test_torch_families.py)
# ---------------------------------------------------------------------------


def test_converter_round_trip_bf16_bit_for_bit():
    cfg_r, cfg_t = _configs("gemma3-27b")
    params = jax.jit(ref_build(cfg_r).init)(KEY)
    pt = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params), device="cpu")
    assert pt["embed"].dtype == torch.bfloat16 and "unembed" not in pt  # tied embeddings
    back = lm_params_to_numpy(pt)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(got, np.asarray(want, np.float32))
    again = lm_params_from_numpy(cfg_t, back, device="cpu")
    for a, b in zip(jax.tree.leaves(lm_params_to_numpy(again)), jax.tree.leaves(back)):
        assert np.array_equal(a, b)


def test_converter_carries_xlstm_blocks_and_rejects_a_wrong_tree():
    cfg_r, cfg_t = _configs("xlstm-125m")
    tree = jax.tree.map(np.asarray, jax.jit(ref_build(cfg_r).init)(KEY))
    pt = lm_params_from_numpy(cfg_t, tree, device="cpu")
    assert len(pt["blocks"]) == cfg_t.n_layers and pt["blocks"][1]["bias"].dtype == torch.float32
    tree["blocks"][0]["wq"] = tree["blocks"][0]["wq"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(cfg_t, tree, device="cpu")


def _stacked_init(model, gen, dev):
    """DecoderLM.init as the fifteenth slice drew it: every layer's dict
    first, then ``torch.stack`` over the layers."""
    cfg = model.cfg
    emb = tl.init_dense(gen, (cfg.vocab, cfg.d_model), model.dtype, device=dev)
    layers = [model._layer_init(gen, dev) for _ in range(cfg.n_layers)]

    def stack(ls):
        if isinstance(ls[0], dict):
            return {k: stack([lp[k] for lp in ls]) for k in ls[0]}
        return torch.stack(ls)

    params = {"embed": emb, "layers": stack(layers),
              "final_norm": torch.zeros((cfg.d_model,), dtype=model.dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = tl.init_dense(gen, (cfg.d_model, cfg.vocab), model.dtype, device=dev)
    return params


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llava-next-mistral-7b", "qwen3-moe-30b-a3b",
                                  "gemma3-27b"])
def test_preallocated_init_equals_the_stacked_init(arch):
    """init draws each layer into preallocated (L, ...) leaves: the same bits
    as stacking the per-layer dicts, leaf for leaf, dtypes and shapes too."""
    model = build_model(tcfg.get_config(arch, smoke=True))
    got = model.init(torch.Generator().manual_seed(7), device="cpu")
    want = _stacked_init(model, torch.Generator().manual_seed(7), torch.device("cpu"))
    assert sorted(got) == sorted(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        assert a.is_contiguous()


# ---------------------------------------------------------------------------
# the recurrences through models._scan: the bits of the loops they replaced
# ---------------------------------------------------------------------------


def _loop_mlstm(p, x, H, st, conv):
    """The stateful mLSTM block as its token loop was written before
    ``_scan.scan``: the block's own projections, then mlstm_step token by
    token, the outputs stacked."""
    B, S, D = x.shape
    d_in, hd = 2 * D, 2 * D // H
    ug = tl.rmsnorm(x, p["ln"]) @ p["w_up"]
    u, g = ug.chunk(2, dim=-1)
    hist = torch.cat([conv, u], dim=1)
    c_act = torch.nn.functional.silu(tx._conv4(hist, p["conv_w"], p["conv_b"])[:, -S:, :])
    q = (c_act @ p["wq"]).reshape(B, S, H, hd)
    k = (c_act @ p["wk"]).reshape(B, S, H, hd)
    v = (u @ p["wv"]).reshape(B, S, H, hd)
    i_pre, f_pre = (c_act @ p["w_if"] + p["if_bias"]).chunk(2, dim=-1)
    ys = []
    for t in range(S):
        yt, st = tx.mlstm_step(st, q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
        ys.append(yt)
    y = torch.stack(ys, dim=1).reshape(B, S, d_in) * torch.nn.functional.silu(g)
    return x + y @ p["w_down"], st


def _loop_slstm(p, x, H, state):
    """The sLSTM block's token loop as it was written before ``_scan.scan``."""
    F = torch.nn.functional
    B, S, D = x.shape
    dh = D // H
    wx = (tl.rmsnorm(x, p["ln"]) @ p["W"] + p["bias"]).float()
    c, n, m, h = state
    R = p["R"].float()
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh), R).reshape(B, 4 * D)
        z_, i_, f_, o_ = (wx[:, t] + rec).chunk(4, dim=-1)
        ih, fh = i_.reshape(B, H, dh), f_.reshape(B, H, dh)
        logf = F.logsigmoid(fh)
        m_new = torch.maximum(logf.amax(-1) + m, ih.amax(-1))
        iprime = torch.exp(ih - m_new[..., None]).reshape(B, D)
        fprime = torch.exp(logf + (m - m_new)[..., None]).reshape(B, D)
        c = fprime * c + iprime * torch.tanh(z_)
        n = fprime * n + iprime
        h = torch.sigmoid(o_) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return x + torch.stack(hs, dim=1).to(x.dtype) @ p["w_out"], (c, n, m, h)


def _loop_ssd(x, dt, A_log, B, C, state):
    """Mamba2's sequential recurrence as it was written before
    ``_scan.scan``."""
    A = -torch.exp(A_log)
    st = state.float()
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        st = st * torch.exp(dtt * A)[..., None, None] + (
            x[:, t] * dtt[..., None])[..., None] * B[:, t, None, None, :]
        ys.append(st @ C[:, t, None, :, None])
    return torch.cat(ys, dim=-1).permute(0, 3, 1, 2), st


@pytest.mark.parametrize("tokens", [7, 1], ids=["prefill", "decode"])
@pytest.mark.parametrize("recurrence", ["mlstm", "slstm", "mamba2"])
def test_scanned_recurrences_keep_the_loops_bits(recurrence, tokens):
    """xlstm.py's two recurrences and mamba2.py's, now through
    ``_scan.scan``, give the bits of the loops they replaced, from a state:
    7 tokens (a prefill) and 1 (a decode step), at the smoke widths."""
    import repro_torch.models.mamba2 as tm

    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(4)
    D, H = 128, 4
    x = _t(rng.normal(size=(2, tokens, D)))
    if recurrence == "mlstm":
        p = tx.mlstm_init(gen, D, H, torch.float32)
        hd = 2 * D // H
        st = (_t(rng.normal(size=(2, H, hd, hd)) * 0.1), _t(rng.normal(size=(2, H, hd)) * 0.1),
              torch.zeros(2, H))
        conv = _t(rng.normal(size=(2, 3, 2 * D)))
        got, (got_st, _) = tx.mlstm_block(p, x, H, state=st, conv_state=conv)
        want, want_st = _loop_mlstm(p, x, H, st, conv)
    elif recurrence == "slstm":
        p = tx.slstm_init(gen, D, H, torch.float32)
        st = (_t(rng.normal(size=(2, D))), _t(np.abs(rng.normal(size=(2, D))) + 1),
              _t(rng.normal(size=(2, H))), _t(rng.normal(size=(2, D))))
        got, got_st = tx.slstm_block(p, x, H, state=st)
        want, want_st = _loop_slstm(p, x, H, st)
    else:
        h, pd, n = 4, 32, 16
        args = (_t(rng.normal(size=(2, tokens, h, pd))), _t(np.abs(rng.normal(size=(2, tokens, h)))),
                _t(rng.normal(size=(h,))), _t(rng.normal(size=(2, tokens, n))),
                _t(rng.normal(size=(2, tokens, n))))
        st = _t(rng.normal(size=(2, h, pd, n)))
        got, got_st = tm._ssd_sequential(*args, state=st)
        want, want_st = _loop_ssd(*args, st)
        got_st, want_st = (got_st,), (want_st,)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_st, want_st))
