"""Production training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --steps 30 --batch 8 --seq 512 [--ckpt-dir DIR] [--resume]          # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --smoke --steps 6 --batch 2 --seq 32 --device cpu                   # the CPU

The port of the reference's ``launch/train.py``: builds the architecture
(its published config, or ``--smoke``'s reduced one), runs the train step
(``repro_torch.train``) over the synthetic token pipeline
(``token_batches(vocab, batch, seq, steps, seed=1)``) with a checkpoint
every ``--ckpt-every`` steps and after the last, and resumes from the
newest checkpoint under ``--resume``. A vlm gets zero image embeddings and
an encdec zero audio frames, as the reference's launcher builds them. It
runs on the card unless ``--device cpu`` is given.

Beyond the reference's flags: ``--remat`` (default "none", as the
reference's launcher builds its model) sets what the backward pass
recomputes; ``--stop-after N`` ends the run after step N
without a checkpoint of its own (a preemption: a later ``--resume`` run
takes the newest checkpoint before it); ``--ckpt-every 0`` writes none;
``--deterministic`` runs under ``torch.use_deterministic_algorithms`` so a
resumed run can be held to an uninterrupted one bit for bit. ``main(argv)``
returns each step's loss and grad norm, the final state and the timings.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch._tree import leaves
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, list_archs
from repro_torch.data.tokens import token_batches
from repro_torch.models import build_model
from repro_torch.train import TrainCfg, init_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25, help="0: no checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--remat", default="none",
                    help="what the backward pass recomputes (build_model's remat): none, full, ...")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="end after this step without its checkpoint (0: run every step)")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    args = parse_args(argv)
    dev = torch.device(args.device)
    say = (lambda *a, **k: None) if args.quiet else print
    det_before = torch.are_deterministic_algorithms_enabled()
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        return _run(args, dev, say)
    finally:
        torch.use_deterministic_algorithms(det_before)


def _run(args, dev, say):
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, remat=args.remat)
    tcfg = TrainCfg(peak_lr=args.lr, warmup_steps=max(2, args.steps // 10),
                    total_steps=args.steps, microbatches=args.microbatches,
                    moment_dtype=cfg.moment_dtype)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), tcfg)
    start = 0
    if args.resume and ckpt.exists(args.ckpt_dir):
        start = int(ckpt.load_meta(args.ckpt_dir)["step"])
        state = ckpt.restore(args.ckpt_dir, state)
        say(f"resumed from step {start}")

    n_params = sum(t.numel() for t in leaves(state["params"]))
    say(f"{cfg.name}: {n_params / 1e6:.1f}M params; steps {start}->{args.steps} on {dev}")
    step_fn = make_train_step(model, tcfg)

    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = torch.zeros((args.batch, cfg.n_patches, cfg.d_model),
                                             dtype=torch.bfloat16, device=dev)
    if cfg.family == "encdec":
        extras["frames"] = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                                       dtype=torch.float32, device=dev)

    stop = args.stop_after or args.steps
    losses, gnorms, t_first = [], [], None
    _sync(dev)
    t0 = time.perf_counter()
    batches = token_batches(cfg.vocab, args.batch, args.seq, args.steps, seed=1)
    for i, b in enumerate(batches):
        if i < start:
            continue
        if i >= stop:
            break
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()} | extras
        state, m = step_fn(state, b)
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        if t_first is None:
            _sync(dev)
            t_first = time.perf_counter()
        last = i + 1 == args.steps
        if args.ckpt_every and ((i + 1) % args.ckpt_every == 0 or last) and i + 1 != args.stop_after:
            ckpt.save(args.ckpt_dir, state, meta={"step": i + 1})
            tokens = args.batch * args.seq * (i + 1 - start)
            say(f"step {i + 1:5d} loss={float(m['loss']):.4f} "
                f"tok/s={tokens / (time.perf_counter() - t0):.0f} [ckpt]", flush=True)
    _sync(dev)
    t_end = time.perf_counter()
    n_run = len(losses)
    ms = (t_end - t_first) / (n_run - 1) * 1e3 if n_run > 1 else None
    say(f"done in {t_end - t0:.1f}s")
    return {
        "arch": cfg.name, "n_params": n_params, "start": start, "steps_run": n_run,
        "losses": [float(x) for x in losses], "grad_norms": [float(x) for x in gnorms],
        "state": state, "seconds": t_end - t0, "ms_per_step": ms,
        "tokens_per_s": None if ms is None else args.batch * args.seq * 1e3 / ms,
    }


if __name__ == "__main__":
    main()
