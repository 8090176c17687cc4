"""End-to-end LM training on the PyTorch/CUDA port, with checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_lm.py                # lm-15m, 60 steps, on the card
    PYTHONPATH=src python examples/torch_train_lm.py --full         # lm-100m, 300 steps
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 8 --batch 2 --seq 16

The twin of examples/train_lm.py: config -> model build -> synthetic token
stream -> train step (microbatch accumulation, AdamW, the warmup-cosine
schedule) -> a checkpoint every 20 steps (and after the first) through
repro_torch.checkpoint.ckpt, the state ``{"params", "opt": AdamWState}`` in
the reference's flatten order -> a simulated preemption at step 30
(``--crash-at``; 0 for none) and a resume from the last durable
checkpoint. ``--deterministic`` runs under
``torch.use_deterministic_algorithms`` (the embedding's backward otherwise
accumulates with atomics on the card), so a resumed run can be held to an
uninterrupted one bit for bit. ``main(argv)`` returns each step's loss (the
resumed steps' where they were run twice), the final state and the step
resumed at.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data import token_batches
from repro_torch.models import build_model
from repro_torch.train import TrainCfg, init_state, make_train_step


def small_cfg(full: bool) -> ArchConfig:
    if full:  # ~100M params
        return ArchConfig(
            name="lm-100m", family="dense", n_layers=8, d_model=640,
            n_heads=10, n_kv_heads=5, d_ff=2560, vocab=50304, mlp="swiglu",
        )
    return ArchConfig(  # ~15M params
        name="lm-15m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=1024, vocab=8192, mlp="swiglu",
    )


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--crash-at", type=int, default=30, help="0: no preemption")
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    say = (lambda *a, **k: None) if args.quiet else print

    cfg = small_cfg(args.full)
    steps = args.steps or (300 if args.full else 60)
    batch = args.batch or (4 if args.full else 8)
    seq = args.seq or (256 if args.full else 128)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_lm_ckpt_")

    det_before = torch.are_deterministic_algorithms_enabled()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        model = build_model(cfg, remat="none")
        tcfg = TrainCfg(
            peak_lr=1e-3 if args.full else 3e-3,
            warmup_steps=min(10, steps // 4),
            total_steps=steps,
            microbatches=1,
        )
        state = init_state(model, torch.Generator(device=dev).manual_seed(0), tcfg)
        n_params = sum(t.numel() for t in _leaves(state["params"]))
        say(f"model {cfg.name}: {n_params / 1e6:.1f}M params, {steps} steps, "
            f"batch {batch}x{seq}, device {dev}")
        step_fn = make_train_step(model, tcfg)
        batches = list(token_batches(cfg.vocab, batch, seq, steps, seed=1))
        losses = [None] * steps
        t0 = time.time()

        def run(state, start, stop):
            for i in range(start, stop):
                b = {k: torch.as_tensor(v, device=dev) for k, v in batches[i].items()}
                state, m = step_fn(state, b)
                losses[i] = float(m["loss"])
                if (i + 1) % 20 == 0 or i == 0:
                    toks = batch * seq * (i + 1)
                    say(f"step {i + 1:4d} loss={losses[i]:.4f} lr={float(m['lr']):.2e} "
                        f"gnorm={float(m['grad_norm']):.2f} tok/s={toks / (time.time() - t0):.0f}",
                        flush=True)
                    ckpt.save(ckpt_dir, state, meta={"step": i + 1})
            return state

        resumed_at = None
        if args.crash_at <= 0:
            state = run(state, 0, steps)
        else:
            state = run(state, 0, min(args.crash_at, steps))
            say("-- simulated preemption: restoring from last durable checkpoint --")
            resumed_at = ckpt.load_meta(ckpt_dir)["step"]
            state = ckpt.restore(ckpt_dir, state)
            say(f"-- resumed at step {resumed_at} --")
            state = run(state, resumed_at, steps)
        sync(dev)
        say(f"done in {time.time() - t0:.1f}s; final loss {losses[-1]:.4f}")
    finally:
        torch.use_deterministic_algorithms(det_before)
    return {"losses": losses, "state": state, "resumed_at": resumed_at, "arch": cfg.name,
            "ckpt_dir": ckpt_dir, "n_params": n_params}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    main()
