"""The port's continuous batcher (repro_torch.serve.ContinuousBatcher) on the
CPU: the exactness and utilisation cases of the reference's
tests/test_serving.py run on the port, its tokens held to the reference's
batcher on an f32 copy of the config, and the slot scatter's leaf rules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro.serve import ContinuousBatcher as RefBatcher
from repro.serve import Request as RefRequest

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model
from repro_torch.serve import ContinuousBatcher, Request, SchedulerStats
from repro_torch.serve import scheduler as shim
from repro_torch.serve.token_scheduler import _scatter_slot

KEY = jax.random.PRNGKey(0)


def _generate(model, params, prompt, n_new, max_len=128):
    """Single-request greedy decode on the port (the reference test's
    procedure): the ground truth per request."""
    logits, state = model.prefill(
        params, {"tokens": torch.as_tensor(prompt[None, :]), "max_len": max_len})
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(n_new - 1):
        logits, state = model.decode_step(params, state, torch.tensor([[toks[-1]]], dtype=torch.int32))
        toks.append(int(torch.argmax(logits[0])))
    return toks


@pytest.fixture(scope="module")
def xlstm_model():
    cfg = get_config("xlstm-125m", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params


def _requests(cls, vocab, lengths, seed, prompt_len=None):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, prompt_len or 8 + 4 * i).astype(np.int32),
                max_new=n) for i, n in enumerate(lengths)]


def test_scheduler_exactness(xlstm_model):
    """Tokens from slot-batched continuous decoding == single-request decode."""
    cfg, model, params = xlstm_model
    reqs = _requests(Request, cfg.vocab, [6, 6, 6], seed=0)
    refs = [_generate(model, params, r.prompt, r.max_new) for r in reqs]
    stats = ContinuousBatcher(model, params, n_slots=2).run(reqs)
    assert stats.finished == 3 and stats.admitted == 3
    for r, ref in zip(reqs, refs):
        assert r.done
        assert r.generated == ref, (r.rid, r.generated, ref)


def test_scheduler_utilization_beats_static(xlstm_model):
    """Mixed-length workload: continuous batching wastes fewer slot-tokens
    than static batching (which holds every slot until the longest request
    of its batch finishes)."""
    cfg, model, params = xlstm_model
    lengths = [2, 4, 16, 16, 4, 2]
    reqs = _requests(Request, cfg.vocab, lengths, seed=1, prompt_len=8)
    stats = ContinuousBatcher(model, params, n_slots=2).run(reqs)
    assert stats.finished == len(reqs)
    static_util = sum(lengths) / (2 * (4 + 16 + 4))
    assert stats.utilization > static_util - 0.05
    assert stats.utilization > 0.7
    assert all(len(r.generated) == n for r, n in zip(reqs, lengths))


def test_batcher_tokens_equal_the_reference_batcher_f32():
    """The port's batcher and the reference's, on an f32 copy of the smoke
    config and the reference's weights: the same tokens for every request
    (f32 logits agree to ~1e-5 of their scale; a parting is allowed only
    where the reference's solo top-two logits lie within 1e-3 of it)."""
    cfg_r = dataclasses.replace(ref_config("xlstm-125m", smoke=True), param_dtype="float32",
                                act_dtype="float32")
    cfg_t = dataclasses.replace(get_config("xlstm-125m", smoke=True), param_dtype="float32",
                                act_dtype="float32")
    model_r = ref_build(cfg_r)
    params_r = jax.jit(model_r.init)(KEY)
    model_t = build_model(cfg_t)
    params_t = lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, params_r), device="cpu")
    lengths = [5, 3, 7, 2, 4]
    reqs_r = _requests(RefRequest, cfg_r.vocab, lengths, seed=2)
    reqs_t = _requests(Request, cfg_t.vocab, lengths, seed=2)
    stats_r = RefBatcher(model_r, params_r, n_slots=3, max_len=64).run(reqs_r)
    stats_t = ContinuousBatcher(model_t, params_t, n_slots=3, max_len=64).run(reqs_t)
    assert dataclasses.asdict(stats_t) == dataclasses.asdict(stats_r)
    dec = jax.jit(model_r.decode_step)
    for rr, rt in zip(reqs_r, reqs_t):
        if rt.generated == rr.generated:
            continue
        t = next(i for i, (a, b) in enumerate(zip(rt.generated, rr.generated)) if a != b)
        logits, st = model_r.prefill(params_r, {"tokens": jnp.asarray(rr.prompt[None]), "max_len": 64})
        for tok in rr.generated[:t]:
            logits, st = dec(params_r, st, jnp.asarray([[tok]], jnp.int32))
        top2 = np.sort(np.asarray(logits[0]))[-2:]
        assert top2[1] - top2[0] <= 1e-3 * np.abs(np.asarray(logits[0])).max(), (rr.rid, t)


def test_eos_releases_the_slot(xlstm_model):
    cfg, model, params = xlstm_model
    prompt = np.arange(10, dtype=np.int32)
    solo = _generate(model, params, prompt, 8)
    req = Request(rid=0, prompt=prompt, max_new=8, eos_id=solo[2])
    stats = ContinuousBatcher(model, params, n_slots=2).run([req])
    stop = solo.index(solo[2])
    assert req.done and req.generated == solo[: stop + 1]
    assert stats.finished == 1 and stats.steps == stop


def test_scatter_slot_leaf_rules():
    big = {"c": [((torch.zeros(3, 2, 2), torch.zeros(3, 2)), torch.zeros(3, 4, dtype=torch.bfloat16)),
                 (torch.zeros(3, 5), torch.ones(2, 2))],
           "scalar": torch.tensor(7)}
    small = {"c": [((torch.ones(1, 2, 2), 2 * torch.ones(1, 2)), 3 * torch.ones(1, 4)),
                   (4 * torch.ones(1, 5), 5 * torch.ones(2, 2))],
             "scalar": torch.tensor(9)}
    out = _scatter_slot(big, small, 1)
    (C, n), conv = out["c"][0]
    assert C[1].eq(1).all() and C[0].eq(0).all() and C[2].eq(0).all()
    assert n[1].eq(2).all() and n[[0, 2]].eq(0).all()
    assert conv.dtype == torch.bfloat16 and conv[1].eq(3).all() and conv[0].eq(0).all()
    assert out["c"][1][0][1].eq(4).all() and out["c"][1][0][[0, 2]].eq(0).all()
    assert out["c"][1][1].eq(1).all()  # equal shapes pass through, as in the reference
    assert int(out["scalar"]) == 7  # scalars pass through
    assert isinstance(out["c"][0], tuple) and isinstance(out["c"], list)


def test_stats_and_shim_names():
    assert SchedulerStats().utilization == 0.0
    assert SchedulerStats(slot_busy_tokens=3, slot_idle_tokens=1).utilization == 0.75
    assert (shim.ContinuousBatcher, shim.Request, shim.SchedulerStats) == (
        ContinuousBatcher, Request, SchedulerStats)
    import repro.serve as rs
    import repro_torch.serve as ts
    assert sorted(ts.__all__) == sorted(rs.__all__)
