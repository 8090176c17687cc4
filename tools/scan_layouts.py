#!/usr/bin/env python3
"""Time B1's and B3's launch layouts (``scan_plan``) at chip_smoke.py's shapes.

    python3 tools/scan_layouts.py [--rounds 3] [--device cuda|cpu]

Each launch runs in every layout it can take, reached as the entry points
reach them: through the shared-memory budget (``smem_budget``: 8 models per
CTA at the card's limit, 4 under a 60,000 B budget at D = 784 or 150,000 B
at D = 4,096, the chunked kernels under 25,888 B) and, for B3, through
``SMALL_BANK_MAX_LIVE`` (0: the bank layouts only; 10**9: the small layout
at any live count). Each layout is held bit-equal to the ring, B6 train,
before it is timed; the layouts are then timed in turns, ``--rounds`` times
(``chip_smoke.time_ms``: CUDA-event means over back-to-back launches after a
warm-up).

Launches, at chip_smoke.py's defaults (seed 0):
- B1 at phase 3's first chunk (8,191 rows, 600 models padded to 640, D = 784)
  and at phase 7b's launch (59,999 rows, 1,536 models, D = 4,096);
- B3 at Fig 3's launch (one live model over 11,799 permuted mnist89 rows,
  L = 10 and 50), at phase 4b's launch (59,999 rows, 600 live models, L = 10),
  on 4b's stream with its first 132 and 66 models (either side of the small
  layout's switch at SMALL_BANK_MAX_LIVE = 132), and at phase 7b's launch.

Prints one line per launch: each layout's readings in ms, in the order
timed. ``--device cpu`` rehearses the script at chip_smoke.py's shapes
through the plain versions (slow: use it only to check the script).
"""
import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import chip_smoke as smoke  # noqa: E402


def layouts(kernel, ring, inp, kw, budgets, dev, rounds):
    """Each (label, budget, SMALL_BANK_MAX_LIVE) run of ``kernel`` bit-equal
    to the ring, then timed in turns; returns "label: ms, ms, ..." parts."""
    from repro_torch.kernels import streamsvm_scan as scan_mod

    keep = scan_mod.SMALL_BANK_MAX_LIVE
    ref = ring(*inp, **smoke.no_live(kw))
    runs = []
    try:
        for budget, small in budgets:
            scan_mod.SMALL_BANK_MAX_LIVE = keep if small is None else small
            plan = smoke.plan_of(inp, kw, budget)
            smoke.check_equal(f"{smoke.layout_note(plan)} against the ring",
                              kernel(*inp, **kw, smem_budget=budget), ref)
            label = ("small" if plan["layout"] == "small"
                     else f"{plan['layout']} x{plan['models_per_cta']}")
            runs.append((label, budget, scan_mod.SMALL_BANK_MAX_LIVE, []))
        reps = 1 if dev.type == "cpu" else max(2, int(400 / max(1.0, smoke.time_ms(
            lambda: kernel(*inp, **kw), dev, 1))))
        for _ in range(rounds):
            for label, budget, small, out in runs:
                scan_mod.SMALL_BANK_MAX_LIVE = small
                out.append(smoke.time_ms(lambda: kernel(*inp, **kw, smem_budget=budget), dev,
                                         reps))
    finally:
        scan_mod.SMALL_BANK_MAX_LIVE = keep
    return [f"{label} " + ", ".join(f"{ms:.4f}" for ms in out) for label, _, _, out in runs]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    from repro_torch.core import ovr_signs
    from repro_torch.data import mnist89_like, permuted, preprocess_for
    from repro_torch.kernels.streamsvm_scan import (
        SCAN_SMEM,
        streamsvm_scan_lookahead_many,
        streamsvm_scan_lookahead_many_ring,
        streamsvm_scan_many,
        streamsvm_scan_many_ring,
    )

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("scan_layouts.py: no CUDA card")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    b1 = (streamsvm_scan_many, streamsvm_scan_many_ring)
    b3 = (streamsvm_scan_lookahead_many, streamsvm_scan_lookahead_many_ring)
    floor = sum(SCAN_SMEM.values())  # the chunked kernels: 25,888 B
    bank = ((None, 0), (60_000, 0), (floor, 0))  # 8 models, 4, chunked
    rounds = args.rounds

    def show(name, parts):
        print(f"{name}: " + "; ".join(parts), flush=True)

    # Phase 3's chunk and phase 4b's stream: 200 classes x 3 C, D = 784.
    Xtr, ytr = smoke.make_blobs(60_000, 200, 784, seed=0)
    Y = np.tile(ovr_signs(ytr, 200, device="cpu").numpy(), (3, 1))
    cs = torch.as_tensor(np.repeat(np.asarray((1.0, 10.0, 100.0), np.float32), 200), device=dev)
    Xd, Yd = torch.as_tensor(Xtr, device=dev), torch.as_tensor(Y, device=dev)
    inp, n, _ = smoke.seeded_bank_inputs(Xd[:8192], Yd[:, :8192], cs, 640)
    show(f"B1 at phase 3's chunk (N={n}, B=600, D=784)",
         layouts(*b1, inp, dict(n_valid=n), bank, dev, rounds))
    for b in (600, 132, 66):
        bp = -(-b // 64) * 64
        inp, n, live = smoke.seeded_bank_inputs(Xd, Yd[:b], cs[:b], bp)
        kw = dict(lookahead=torch.where(live, 10, 1).to(torch.int32), lookahead_max=10,
                  n_valid=n, n_live=b)
        show(f"B3 on 4b's stream (N={n}, {b} live of {bp}, D=784, L=10)",
             layouts(*b3, inp, kw, ((None, 10**9),) + bank, dev, rounds))
    del Xd, Yd

    # Fig 3's single-model launch.
    Xf, yf, Xfte, _ = mnist89_like(seed=0)
    Xf, _ = preprocess_for("mnist89", Xf[:11_800], Xfte[:1])
    Xp, yp = permuted(Xf, yf[:11_800], seed=0)
    Xp, yp = torch.as_tensor(Xp, device=dev), torch.as_tensor(yp, device=dev)
    inp, n, live = smoke.seeded_bank_inputs(Xp, yp[None, :], torch.full((1,), 10.0, device=dev), 8)
    for L in (10, 50):
        kw = dict(lookahead=torch.where(live, L, 1).to(torch.int32), lookahead_max=L,
                  n_valid=n, n_live=1)
        show(f"B3 at Fig 3's launch (N={n}, one model, D=784, L={L})",
             layouts(*b3, inp, kw, ((None, None),) + bank, dev, rounds))

    # Phase 7b's launch: 512 classes x 3 C, D = 4,096 (fit_bank's b_tile 64
    # pads no lane).
    Xr, yr = smoke.make_blobs_on(60_000, 512, 4096, 0, dev)
    Yr = ovr_signs(yr, 512, device=dev).repeat(3, 1)
    csr = torch.tensor(smoke.RING_C, device=dev).repeat_interleave(512)
    inp, n, live = smoke.seeded_bank_inputs(Xr, Yr, csr, 1536)
    wide = ((None, 0), (150_000, 0), (floor, 0))
    show(f"B1 at 7b's launch (N={n}, B=1536, D=4096)",
         layouts(*b1, inp, dict(n_valid=n), wide, dev, rounds))
    kw = dict(lookahead=torch.where(live, 10, 1).to(torch.int32), lookahead_max=10, n_valid=n)
    show(f"B3 at 7b's launch (N={n}, B=1536, D=4096, L=10)",
         layouts(*b3, inp, kw, wide[:2], dev, rounds))


if __name__ == "__main__":
    main()
