#!/usr/bin/env python3
"""Planted decode faults against chip_smoke.py's 12e check.

    python3 tools/hybrid_faults.py                   # on a card: zamba2-1.2b as 12e runs it
    python3 tools/hybrid_faults.py --device cpu --smoke --batch 2 --prompt 32 --gen 8

Phase 12e serves zamba2-1.2b (batch 8, prompt 512, 128 greedy tokens) and
holds every step's bf16 logits to the bf16 teacher-forced forward over the
same tokens within ZOO_HYBRID_TF_TOL x max|logit|. This script takes that
reading step by step for the sound model (12e's weights, drawn from
--seed) and for the model with each of FAULTS planted, and prints each
run's worst step beside the bound and whether the check catches it. The
faults are planted by wrapping the port's functions for one run; no source
changes. tests/test_torch_families.py plants the same faults at smoke size.
"""
import argparse
import contextlib
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models import families, mamba2  # noqa: E402

FAULTS = {
    "stale_conv": "decode's conv state never advances",
    "ssm_reset": "decode drops each Mamba2 layer's SSM state",
    "stale_pos": "the cache position does not advance (the same KV slot, the same position)",
    "ssm_bf16": "the SSM state rounded to bf16 after each decode step",
    "dt_bf16": "the recurrence's softplus(dt) rounded to bf16",
}


@contextlib.contextmanager
def planted(kind):
    """Plant ``kind``, one of FAULTS (None plants nothing), until the block
    ends. The Mamba2 faults act on decode steps (one token) only."""
    saved_apply, saved_seq = families.mamba_apply, mamba2._ssd_sequential
    saved_steps = {c: c.decode_step for c in (families.Zamba2Model, families.EncDecModel)}

    def apply(p, x, ssm, *, state=None, conv_state=None):
        out, (st, cv) = saved_apply(p, x, ssm, state=state, conv_state=conv_state)
        if x.shape[1] == 1:
            if kind == "stale_conv":
                cv = conv_state
            elif kind == "ssm_reset":
                st = torch.zeros_like(st)
            elif kind == "ssm_bf16":
                st = st.to(torch.bfloat16).float()
        return out, (st, cv)

    def sequential(x, dt, A_log, B, C, state=None):
        return saved_seq(x, dt.to(torch.bfloat16).float(), A_log, B, C, state=state)

    def stale(step):
        def decode_step(self, params, cache, tokens):
            logits, new = step(self, params, cache, tokens)
            return logits, {**new, "pos": cache["pos"]}
        return decode_step

    if kind in ("stale_conv", "ssm_reset", "ssm_bf16"):
        families.mamba_apply = apply
    elif kind == "dt_bf16":
        mamba2._ssd_sequential = sequential
    elif kind == "stale_pos":
        for cls, step in saved_steps.items():
            cls.decode_step = stale(step)
    elif kind is not None:
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        families.mamba_apply, mamba2._ssd_sequential = saved_apply, saved_seq
        for cls, step in saved_steps.items():
            cls.decode_step = step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true", help="the smoke config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--gen", type=int, default=128)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "examples"))
    import chip_smoke as smoke
    import torch_serve
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device(args.device)
    cfg = get_config(smoke.ZOO_HYBRID, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    B, P, G = args.batch, args.prompt, args.gen
    batch = torch_serve.make_batch(cfg, B, P, args.seed, dev)
    tol = smoke.ZOO_HYBRID_TF_TOL
    print(f"{cfg.name} ({cfg.n_layers} Mamba2 layers, d_model {cfg.d_model}, {cfg.param_dtype}) on "
          f"{dev}, batch {B}, prompt {P}, {G} greedy tokens; the bound {tol} x max|logit|")
    out = {}
    for kind in (None, *FAULTS):
        t0 = time.perf_counter()
        with planted(kind):
            res = torch_serve.serve(model, params, batch, G, keep_logits=True)
        seq = torch.cat([batch["tokens"], res["tokens"]], dim=1)
        tf = smoke.teacher_forced_logits(model, params, seq, P, G)
        errs = [smoke.rel_err(res["logits"][j], tf[:, j]) for j in range(G)]
        worst = max(errs)
        over = [j for j, e in enumerate(errs) if e > tol]
        name = kind or "sound"
        out[name] = worst
        print(f"  {name:10s} worst step {errs.index(worst)} at {worst:.4g} x max|logit|; steps 0-3 "
              f"{', '.join(f'{e:.4g}' for e in errs[:4])}; "
              + (f"{len(over)} of {G} steps over the bound, the first {over[0]}: caught"
                 if over else "no step over the bound: not caught")
              + f" ({time.perf_counter() - t0:.1f} s){'' if kind is None else ': ' + FAULTS[kind]}")
    return out


if __name__ == "__main__":
    main()
