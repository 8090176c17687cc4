"""The dry run's memory analysis (``launch/memory.py``) on the CPU, one rank,
no DTensor.

- The live-bytes count is exact on a hand-built sequence of ops whose live
  bytes are known: storages made and freed, views, an argument written in
  place and returned, a storage resized in place.
- A prefill, a decode step and a train step of each smoke family count the
  same bytes on meta tensors as on CPU tensors (the card's check predicts
  from meta).
- A recurrence counted once (``models._scan``) gives the bytes of walking
  every step, forward and backward, with and without remat.
- One microbatch reckoned for A (``dryrun.train_memory``) gives the bytes
  of ``make_train_step`` run at A = 2 and 4.
"""
import dataclasses
from contextlib import nullcontext

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.memory import LiveBytes, peaks
from repro_torch.models import build_model
from repro_torch.models._scan import count_once
from repro_torch.optim import adamw
from repro_torch.train import TrainCfg, make_train_step

ARCHS = ["internlm2-1.8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-base", "xlstm-125m"]
FIELDS = ("output_size_in_bytes", "temp_size_in_bytes", "peak_bytes")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_live_bytes_exact_on_known_ops(device):
    """x (an argument, 400 B) is written in place and returned; a (400) is
    made and freed; b (400) and its view c live to the end, d = cat(b, b)
    (800) and e (resized from 0 to 40 floats, 160) are returned. Peak of all
    step-made bytes: a + b + d = 1,600 (a freed first: b + d + e = 1,360);
    temp peaks at a + b = 800 (d and e are outputs); outputs 400 + 800 +
    160 = 1,360."""
    x = torch.zeros(100, device=device)
    counter = D.CellCounter()
    assert counter.live.arguments({"x": x}) == 400
    with counter:
        x.add_(1.0)
        a = torch.ones(100, device=device)
        b = a * 2
        c = b.view(10, 10)
        d = torch.cat([b, b])
        del a
        e = torch.empty(0, device=device)
        e.resize_(40)
        out = {"x": x, "d": d, "e": e}
    got = counter.live.summary(out)
    assert got == {"output_size_in_bytes": 1360, "temp_size_in_bytes": 800, "peak_bytes": 1600}
    assert c.shape == (10, 10)


def test_peaks_keep_outputs_out_of_temp():
    assert peaks([(False, 5), (True, 7), (False, -5), (False, 3)]) == (12, 5)


def test_storages_die_with_their_last_view():
    live = LiveBytes()
    live.arguments(torch.zeros(1))
    t = torch.ones(8)
    v = t[2:]
    live.made(t)
    del t
    assert [d for _, d in live.events] == [32]
    del v
    assert [d for _, d in live.events] == [32, -32]


def _batch(cfg, B, S, device, seed=0, targets=True):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g).to(device)}
    if targets:
        batch["targets"] = torch.randint(0, cfg.vocab, (B, S), generator=g).to(device)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=g).to(device)
    return batch


def _state(model, cfg, device):
    gen = torch.Generator().manual_seed(0) if device == "cpu" else None
    params = model.init(gen, device=device)
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype]
    return {"params": params, "opt": adamw.init(params, mdt)}


def _bytes(arch, kind, device):
    cfg = get_config(arch, smoke=True)
    if kind == "train":
        model = build_model(cfg, remat="full")
        state = _state(model, cfg, device)
        return D.train_memory(model, TrainCfg(moment_dtype=cfg.moment_dtype), state,
                              _batch(cfg, 2, 16, device))
    model = build_model(cfg)
    params = _state(model, cfg, device)["params"]
    if kind == "prefill":
        batch = {**_batch(cfg, 2, 16, device, targets=False), "max_len": 20}
        return D.step_memory(lambda: model.prefill(params, batch), (params, batch))
    cache = model.decode_state(2, 20, device=device)
    tokens = torch.zeros((2, 1), dtype=torch.int32, device=device)
    return D.step_memory(lambda: model.decode_step(params, cache, tokens),
                         (params, cache, tokens))


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_counts_the_bytes_of_cpu(arch, kind):
    """The smoke config's step counts the same output, temp and peak bytes
    on meta tensors as on CPU tensors, exactly."""
    cpu, meta = _bytes(arch, kind, "cpu"), _bytes(arch, kind, "meta")
    assert cpu == meta
    assert cpu["output_size_in_bytes"] > 0 and cpu["temp_size_in_bytes"] > 0
    assert cpu["peak_bytes"] >= cpu["temp_size_in_bytes"]


def _slstm(s, once, remat, device="cpu"):
    from repro_torch.models.transformer import remat_layer
    from repro_torch.models.xlstm import slstm_block, slstm_init

    g = torch.Generator().manual_seed(s)
    p = {k: v.to(device).requires_grad_() for k, v in slstm_init(g, 16, 4, torch.float32).items()}
    x = torch.randn((2, s, 16), generator=g).to(device).requires_grad_()
    fn = remat_layer(lambda p, x: slstm_block(p, x, 4)[0], remat)
    counter = D.CellCounter()
    counter.live.arguments((p, x))
    with counter, count_once(counter) if once else nullcontext():
        y = fn(p, x)
        (y * y).sum().backward()
        out = [v.grad for v in p.values()] + [x.grad]
    return counter.live.summary(out), counter.scans


def _mamba2(s, once):
    from repro_torch.models.mamba2 import _ssd_sequential

    g = torch.Generator().manual_seed(s)
    shapes = {"x": (2, s, 3, 4), "dt": (2, s, 3), "A_log": (3,), "B": (2, s, 5), "C": (2, s, 5)}
    ins = {k: torch.randn(v, generator=g).requires_grad_() for k, v in shapes.items()}
    counter = D.CellCounter()
    counter.live.arguments(ins)
    with counter, count_once(counter) if once else nullcontext():
        y, st = _ssd_sequential(ins["x"], ins["dt"].abs(), ins["A_log"], ins["B"], ins["C"])
        (y.sum() + st.sum()).backward()
        out = [v.grad for v in ins.values()]
    return counter.live.summary(out), counter.scans


@pytest.mark.parametrize("case", ["slstm-none-4", "slstm-none-7", "slstm-none-33",
                                  "slstm-full-7", "slstm-full-33", "mamba2-4", "mamba2-7"])
def test_recurrence_counted_once_gives_the_walks_bytes(case):
    """The sLSTM block's recurrence (its carry's h kept as the next step's
    saved input; with remat "full" recomputed in the backward, where the
    forward's nodes free the recomputed copies) and Mamba2's, forward and
    backward, over s tokens: counted once, the output, temp and peak bytes
    equal the walk's exactly."""
    name, *rest = case.split("-")
    if name == "slstm":
        remat, s = rest[0], int(rest[1])
        (once, scans), (walk, _) = _slstm(s, True, remat), _slstm(s, False, remat)
        assert scans == {"slstm": {s: 1 if remat == "none" else 2}}  # remat: recomputed
    else:
        s = int(rest[0])
        (once, scans), (walk, _) = _mamba2(s, True), _mamba2(s, False)
        assert scans == {"mamba2": {s: 1}}
    assert once == walk and once["temp_size_in_bytes"] > 0


def test_recurrence_counted_once_needs_its_weighted_middle_step(monkeypatch):
    """The check above is not vacuous: without ``persist``'s weight the
    sLSTM counted once at 33 tokens misses at least 30 steps' (B, D) f32
    carry (128 B each) that the walk holds at its peak."""
    walk, _ = _slstm(33, False, "none")
    monkeypatch.setattr(LiveBytes, "persist", lambda self, *a, **k: None)
    bare, _ = _slstm(33, True, "none")
    assert walk["peak_bytes"] - bare["peak_bytes"] >= 30 * 128


@pytest.mark.parametrize("A", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_microbatch_reckons_the_a_step(arch, A):
    """``train_memory`` at A microbatches, from one microbatch run and the
    update on f32 accumulators, equals ``make_train_step`` run at A on A
    times the batch, exactly (a fresh model each: Whisper's position table
    is a cache its first call makes)."""
    cfg = get_config(arch, smoke=True)
    tcfg = TrainCfg(moment_dtype=cfg.moment_dtype)
    model = build_model(cfg, remat="full")
    state = _state(model, cfg, "cpu")
    full = _batch(cfg, 2 * A, 16, "cpu")
    mb = {k: v[:2].clone() for k, v in full.items()}
    got = D.train_memory(model, tcfg, state, mb, microbatches=A)
    step = make_train_step(build_model(cfg, remat="full"),
                           dataclasses.replace(tcfg, microbatches=A))
    want = D.step_memory(lambda: step(state, full), (state, full))
    assert got == want
    one = D.train_memory(build_model(cfg, remat="full"), tcfg, state, mb)
    # the f32 accumulators: an A-step holds more than one microbatch's step
    assert got["temp_size_in_bytes"] > one["temp_size_in_bytes"]
    assert set(got) == set(FIELDS)
