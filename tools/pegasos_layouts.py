#!/usr/bin/env python3
"""Time every layout of P2 (Pegasos) on Table 1's streams, in turns.

    PYTHONPATH=src python3 tools/pegasos_layouts.py      # on a machine with a CUDA card
    PYTHONPATH=src python3 tools/pegasos_layouts.py --k 20 --datasets mnist89,w3a

On mnist89 (11,800 x 784) and synthetic_a (20,000 x 2) by default, or
w3a (44,837 x 300), each in Table 1's first stream order at seed 0 with
Table 1's lambda there (1 / (C* N), C* the one-pass grid's pick in
chip_smoke.py phase 11: 100, 1 and 1), for k in K (1 and 20, the paper's,
and the ones between and above, which set the plan's choice): every layout
``kernels.baselines.pegasos_layouts`` lists (the walk in B4's three
layouts where k <= 32; the walk over blocks where it takes k and the rows
are 16-byte pieces; the step form staged and in place), each first held to
the plain version (``chip_smoke.check_p2``:
the same violations row for row, w within the engine tolerance, or a
certified f32 tie), then timed in turns over 3 rounds, each round a mean
over 10 launches back to back, two ways: CUDA events around them (``ms``)
and the same launches queued behind a spin (the card alone). Prints one
line a layout with the rounds' median and range, which layout the plan
takes, and the card's name and power limit. This is the measured reason
for ``PEGASOS_WALK_MAX_K``, ``PEGASOS_BLOCKS_MAX_K`` and
``PEGASOS_BLOCKS_D_PER_K``.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

K = (1, 2, 4, 8, 9, 12, 16, 20, 24, 32, 64)
C_STAR = {"mnist89": 100.0, "synthetic_a": 1.0, "w3a": 1.0}
ROUNDS, REPS = 3, 10


def main(argv=None):
    import argparse

    from repro_torch.data import load_dataset, permuted, preprocess_for
    from repro_torch.kernels import baselines as kbl

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", default=",".join(map(str, K)), help="rows a step, comma-separated")
    ap.add_argument("--datasets", default="mnist89,synthetic_a")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    for name in args.datasets.split(","):
        Xtr, ytr, Xte, _ = load_dataset(name, seed=0)
        Xtr, _ = preprocess_for(name, Xtr, Xte)
        Xtr, ytr = permuted(Xtr, ytr, seed=0)  # Table 1's first stream order
        X, y = torch.as_tensor(Xtr, device=dev), torch.as_tensor(ytr, device=dev)
        n, d = X.shape
        lam = 1.0 / (C_STAR[name] * n)
        for k in map(int, args.k.split(",")):
            nk = n // k * k
            Xk, yk = X[:nk].contiguous(), y[:nk].contiguous()
            plans = kbl.pegasos_layouts(d, k)
            smoke.check_p2(f"{name} k={k}", Xk, yk, lam, k, plans, plain_dev="cpu")
            times = {i: ([], []) for i in range(len(plans))}
            for _ in range(ROUNDS):
                for i, plan in enumerate(plans):
                    launch = lambda w, plan=plan: kbl._launch(plan, Xk, yk, lam, k, w, None)
                    for j, card in enumerate((False, True)):
                        states = [torch.zeros(d, device=dev) for _ in range(REPS + 1)]
                        times[i][j].append(smoke.time_states_ms(launch, states, dev, card))
            planned = kbl.pegasos_plan(d, k)
            for i, plan in enumerate(plans):
                ev, card = times[i]
                print(f"P2 {name} N={nk} D={d} k={k} {smoke.layout_note(plan)}"
                      f"{' (planned)' if plan == planned else ''}: {np.median(ev):.4f} ms a "
                      f"sweep by events ({min(ev):.4f}-{max(ev):.4f}), {np.median(card):.4f} on "
                      f"the card alone ({min(card):.4f}-{max(card):.4f})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
