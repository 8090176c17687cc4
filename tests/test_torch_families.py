"""Zamba2 (the hybrid family) and Whisper (encdec) on the port against the
JAX reference on the CPU, at smoke size, and the port held to itself
(prefill + decode against its full forward).

The reference's parameters are carried across by
``convert.lm_params_from_numpy``; tokens and Whisper's frames come from
numpy seeds. Zamba2's prompts of 32 tokens take the chunked SSD (a
multiple of the smoke chunk), 17 the sequential recurrence; Whisper, which
has no such split, runs one prompt length.

Tolerances, stated before the runs:
- f32 (the smoke configs as f32 copies): prefill and five decode steps'
  logits within F32_LOGIT_TOL = 1e-4 x max|logit| of the reference's; the
  loss within rtol 1e-5; every gradient leaf within rtol 1e-4 and atol
  1e-4 x its max|want| (the backward's sums in other orders);
- bf16 (the smoke configs as published), fed the same tokens: no step's
  logits farther from the reference's f32 run than twice the farthest step
  of the reference's own bf16 run, plus 0.01 x max|logit|; each step within
  BF16_TOL x max|logit| of the reference's bf16 run; the greedy token equal
  wherever the reference's top-two logits part by more than twice that.
  BF16_TOL is 0.04 for Whisper, as for the transformers. For Zamba2 it is
  0.3, as for xLSTM, and the f32 bound is taken over the steps, not step by
  step: the smoke Zamba2's decode in bf16 drifts from its f32 run (the
  reference's own bf16 run lies 0.34 x max|logit| from its f32 run at the
  fourth decode step of the 32-token prompt, 0.04 at the prefill), so two
  bf16 runs land apart by chance at any one step;
- what sets BF16_TOL, as read on these seeds (x max|logit|, the port's
  bf16 run against the reference's, worst step): sound Zamba2 0.2462
  (prompt 32) and 0.1105 (prompt 17), sound Whisper 0.0093; with a decode
  fault planted (tools/hybrid_faults.py's FAULTS) Zamba2 1.2526 / 1.2636
  (the conv state never advanced), 1.1078 / 1.0189 (the SSM state
  dropped), 0.9821 / 0.7684 (the cache position not advanced), Whisper
  0.501 (the position not advanced). Each bound lies between its family's
  sound and faulted readings, and test_bf16_bound_catches_planted_decode_faults
  holds that. The SSM state or softplus(dt) rounded to bf16 read 0.25 and
  0.2117 at prompt 32, inside the sound run's spread: at this size no bf16
  bound tells those from rounding;
- the port against its own full forward: rtol / atol 5e-3 (Zamba2) and 2e-3
  (Whisper), the reference's own consistency tests' bounds.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro.models import build_model as ref_build

import repro_torch.configs as tcfg
from repro_torch._tree import leaves
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import build_model

KEY = jax.random.PRNGKey(0)
F32_LOGIT_TOL = 1e-4
BF16_TOL = {"hybrid": 0.3, "encdec": 0.04}
B, N_DEC = 2, 5
ARCHS = ["zamba2-1.2b", "whisper-base"]


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def _np(x):
    return np.asarray(x, np.float32)


def _inputs(cfg, P):
    rng = np.random.default_rng(P)
    toks = rng.integers(0, cfg.vocab, (B, P + N_DEC + 1)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = (rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    return toks, frames


def _batch(toks, frames, wrap):
    b = {"tokens": wrap(toks)}
    if frames is not None:
        b["frames"] = wrap(frames)
    return b


def _run_reference(cfg, params, toks, frames, P):
    model = ref_build(cfg)
    pf = jax.jit(lambda p, b: model.prefill(p, {**b, "max_len": P + N_DEC}))
    dec = jax.jit(model.decode_step)
    logits, cache = pf(params, _batch(toks[:, :P], frames, jnp.asarray))
    out = [_np(logits)]
    for t in range(N_DEC):
        logits, cache = dec(params, cache, jnp.asarray(toks[:, P + t : P + t + 1]))
        out.append(_np(logits))
    return out


def _run_port(cfg, params, toks, frames, P):
    model = build_model(cfg)
    logits, cache = model.prefill(params, {**_batch(toks[:, :P], frames, torch.as_tensor),
                                           "max_len": P + N_DEC})
    out = [logits.float().numpy()]
    for t in range(N_DEC):
        logits, cache = model.decode_step(params, cache, torch.as_tensor(toks[:, P + t : P + t + 1]))
        out.append(logits.float().numpy())
    return out


def _loss_batch(toks, frames, P):
    lb = _batch(toks[:, :P], frames, np.asarray)
    lb["targets"] = toks[:, 1 : P + 1]
    return lb


@pytest.fixture(scope="module", params=[("zamba2-1.2b", 32), ("zamba2-1.2b", 17),
                                        ("whisper-base", 24)],
                ids=lambda ap: f"{ap[0]}-P{ap[1]}")
def fam(request):
    """The reference's and the port's runs of one smoke architecture at one
    prompt length, f32 and bf16, on the reference's parameters."""
    arch, P = request.param
    cfg_r, cfg_t = rcfg.get_config(arch, smoke=True), tcfg.get_config(arch, smoke=True)
    cfg_r32, cfg_t32 = _f32(cfg_r), _f32(cfg_t)
    toks, frames = _inputs(cfg_r, P)
    params32 = jax.jit(ref_build(cfg_r32).init)(KEY)
    shapes16 = jax.eval_shape(ref_build(cfg_r).init, KEY)
    params16 = jax.tree.map(lambda a, s: a.astype(s.dtype), params32, shapes16)
    pt32 = lm_params_from_numpy(cfg_t32, jax.tree.map(np.asarray, params32), device="cpu")
    pt16 = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params16), device="cpu")
    out = dict(arch=arch, P=P, cfg_r32=cfg_r32, cfg_t32=cfg_t32, params32=params32, pt32=pt32,
               cfg_t=cfg_t, pt16=pt16, toks=toks, frames=frames)
    out["ref32"] = _run_reference(cfg_r32, params32, toks, frames, P)
    out["port32"] = _run_port(cfg_t32, pt32, toks, frames, P)
    out["ref16"] = _run_reference(cfg_r, params16, toks, frames, P)
    out["port16"] = _run_port(cfg_t, pt16, toks, frames, P)
    return out


def _logits_close(got, want, tol):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, tol * scale)


def test_prefill_logits_f32(fam):
    _logits_close(fam["port32"][0], fam["ref32"][0], F32_LOGIT_TOL)


def test_decode_logits_f32(fam):
    assert len(fam["port32"]) == N_DEC + 1
    for got, want in zip(fam["port32"][1:], fam["ref32"][1:]):
        _logits_close(got, want, F32_LOGIT_TOL)


def test_loss_and_grads_f32(fam):
    """The loss within rtol 1e-5 and every gradient leaf within tolerance of
    ``jax.value_and_grad`` of the reference's loss, and finite."""
    lb = _loss_batch(fam["toks"], fam["frames"], fam["P"])
    (l_r, _), g_r = jax.jit(jax.value_and_grad(ref_build(fam["cfg_r32"]).loss, has_aux=True))(
        fam["params32"], {k: jnp.asarray(v) for k, v in lb.items()})
    model = build_model(fam["cfg_t32"])
    ps = [t.detach().clone().requires_grad_() for t in leaves(fam["pt32"])]
    it = iter(ps)
    tree = jax.tree.map(lambda _: next(it), fam["pt32"])  # the same sorted-key order
    l_t, _ = model.loss(tree, lb)
    grads = torch.autograd.grad(l_t, ps)
    np.testing.assert_allclose(float(l_t.detach()), float(l_r), rtol=1e-5)
    want = jax.tree.leaves(g_r)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = _np(w)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1e-12))


def test_bf16_greedy_tokens(fam):
    tol = BF16_TOL[fam["cfg_t32"].family]
    steps = list(zip(fam["port16"], fam["ref16"], fam["ref32"]))
    own = max(np.abs(want - want32).max() for _, want, want32 in steps)
    scale = max(np.abs(want32).max() for _, _, want32 in steps)
    assert max(np.abs(got - want32).max() for got, _, want32 in steps) <= 2 * own + 0.01 * scale
    for got, want, _ in steps:
        _logits_close(got, want, tol)
        top2 = np.sort(want, -1)[:, -2:]
        parts = (top2[:, 1] - top2[:, 0]) > 2 * tol * np.abs(want).max(-1)
        assert (got.argmax(-1)[parts] == want.argmax(-1)[parts]).all()


PLANTED = {"hybrid": ("stale_conv", "ssm_reset", "stale_pos"), "encdec": ("stale_pos",)}


def test_bf16_bound_catches_planted_decode_faults(fam):
    """With a decode fault planted, some step of the port's bf16 run lies
    beyond BF16_TOL x max|logit| of the reference's bf16 run: the bound
    test_bf16_greedy_tokens holds the sound run to fails the faulty one."""
    hybrid_faults = _tool("hybrid_faults")
    fams = fam["cfg_t"].family
    tol = BF16_TOL[fams]
    for kind in PLANTED[fams]:
        with hybrid_faults.planted(kind):
            got = _run_port(fam["cfg_t"], fam["pt16"], fam["toks"], fam["frames"], fam["P"])
        worst = max(np.abs(g - w).max() / np.abs(w).max() for g, w in zip(got, fam["ref16"]))
        assert worst > tol, (kind, worst)
    sound = _run_port(fam["cfg_t"], fam["pt16"], fam["toks"], fam["frames"], fam["P"])
    assert all(np.array_equal(a, b) for a, b in zip(sound, fam["port16"]))  # nothing stayed planted


def _tool(name):
    path = Path(__file__).resolve().parents[1] / "tools"
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
    return importlib.import_module(name)


# ---------------------------------------------------------------------------
# the port against its own full forward
# ---------------------------------------------------------------------------


def _port_f32(arch, seed):
    cfg = _f32(tcfg.get_config(arch, smoke=True))
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("prefill_len", [32, 17])
def test_zamba2_prefill_decode_equals_full_forward(prefill_len):
    """The twin of tests/test_recurrent_consistency.py: 32 takes the chunked
    SSD's state handoff, 17 the sequential recurrence."""
    cfg, model, params = _port_f32("zamba2-1.2b", 3)
    S = prefill_len + 1
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (1, S)), dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": tokens[:, :prefill_len], "max_len": S})
    dec, _ = model.decode_step(params, cache, tokens[:, prefill_len:])
    full, _ = model.prefill(params, {"tokens": tokens, "max_len": S})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3, atol=5e-3)


def test_zamba2_decode_chain_matches_prefill():
    cfg, model, params = _port_f32("zamba2-1.2b", 3)
    S0, n_extra = 32, 3
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, S0 + n_extra)),
                             dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": tokens[:, :S0], "max_len": S0 + n_extra})
    for t in range(n_extra):
        logits, cache = model.decode_step(params, cache, tokens[:, S0 + t : S0 + t + 1])
        want, _ = model.prefill(params, {"tokens": tokens[:, : S0 + t + 1], "max_len": S0 + n_extra})
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=5e-3, atol=5e-3)


def test_whisper_teacher_forced_consistency():
    """The twin of tests/test_models.py::test_prefill_decode_consistency."""
    cfg, model, params = _port_f32("whisper-base", 3)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 16)), dtype=torch.int32)
    frames = torch.as_tensor(rng.normal(size=(1, cfg.encoder_seq, cfg.d_model)) * 0.1,
                             dtype=torch.float32)
    _, cache = model.prefill(params, {"tokens": tokens[:, :15], "frames": frames, "max_len": 17})
    dec, _ = model.decode_step(params, cache, tokens[:, 15:16])
    full, _ = model.prefill(params, {"tokens": tokens, "frames": frames, "max_len": 17})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none(arch):
    """Checkpointed layers recompute the same loss and grads bit for bit."""
    cfg = _f32(tcfg.get_config(arch, smoke=True))
    params = build_model(cfg).init(torch.Generator().manual_seed(5), device="cpu")
    toks, frames = _inputs(cfg, 32)
    lb = _loss_batch(toks, frames, 32)
    out = []
    for remat in ("none", "full"):
        ps = [t.detach().clone().requires_grad_() for t in leaves(params)]
        it = iter(ps)
        tree = jax.tree.map(lambda _: next(it), params)
        loss, _ = build_model(cfg, remat=remat).loss(tree, lb)
        out.append((loss.detach(), torch.autograd.grad(loss, ps)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# the converter and the model registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_carries_the_trees_bf16_bit_for_bit(arch):
    cfg_r, cfg_t = rcfg.get_config(arch, smoke=True), tcfg.get_config(arch, smoke=True)
    params = jax.jit(ref_build(cfg_r).init)(KEY)
    pt = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params), device="cpu")
    if arch.startswith("zamba2"):
        assert len(pt["mamba"]) == cfg_t.n_layers and "attn" in pt["shared"]
        assert pt["mamba"][0]["mix"]["A_log"].dtype == torch.float32
    else:
        assert len(pt["enc_layers"]) == cfg_t.n_encoder_layers
        assert len(pt["dec_layers"]) == cfg_t.n_layers and "xattn" in pt["dec_layers"][0]
    back = lm_params_to_numpy(pt)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(got, np.asarray(want, np.float32))
    tree = jax.tree.map(np.asarray, params)
    first = tree["mamba"][0]["mix"] if arch.startswith("zamba2") else tree["dec_layers"][0]["xattn"]
    key = "in_proj" if arch.startswith("zamba2") else "wq"
    first[key] = first[key][:-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(cfg_t, tree, device="cpu")


@pytest.mark.parametrize("arch", tcfg.list_archs())
def test_build_model_for_every_arch_and_meta_init(arch):
    """Every architecture builds, and its published config initialises on the
    meta device with the reference's leaf shapes and dtypes."""
    model = build_model(tcfg.get_config(arch))
    got = model.init(device="meta")
    want = jax.eval_shape(ref_build(rcfg.get_config(arch)).init, KEY)
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
