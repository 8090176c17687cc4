#!/usr/bin/env python3
"""Time every layout of M1 on benchmarks/beyond.py's stream, beside B4.

    PYTHONPATH=src python3 tools/multiball_layouts.py      # on a machine with a CUDA card

On mnist89 (11,800 x 784, C = 10), for L = 1, 2, 4, 8, every layout
``kernels.multiball.multiball_layouts`` reaches (the stream staged or read
in place, the tables in shared or device memory; each forced by a budget of
its own bytes) is checked bit-equal to the planned one and timed in turns
over 3 rounds, each a mean over 10 launches by CUDA events on fresh copies
of the seeded state; then B4 (Algorithm 1, one model) over the same rows,
the other kernel that walks this stream on one SM. Prints one line a layout
with the rounds' range, and the card's name and power limit.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main():
    from repro_torch.data import load_dataset, preprocess_for
    from repro_torch.kernels import ops
    from repro_torch.kernels.multiball import multiball_layouts, multiball_plan, multiball_scan
    from repro_torch.kernels.streamsvm_scan import streamsvm_scan

    dev = torch.device("cuda")
    Xtr, ytr, _, _ = load_dataset("mnist89")
    Xtr, _ = preprocess_for("mnist89", Xtr, Xtr[:1])
    X, y = torch.as_tensor(Xtr, device=dev), torch.as_tensor(ytr, device=dev)
    c_inv = float(np.float32(0.1))
    reps, rounds = 10, 3
    for L in (1, 2, 4, 8):
        plans = multiball_layouts(L, X.shape[1])
        want = smoke.run_multiball(multiball_scan, X, y, L, c_inv, c_inv)
        times = {i: [] for i in range(len(plans))}
        for _ in range(rounds):
            for i, plan in enumerate(plans):
                budget = sum(plan["smem"].values())
                got = smoke.run_multiball(multiball_scan, X, y, L, c_inv, c_inv,
                                          smem_budget=budget)
                for a, b in zip(got, want):
                    smoke.bit_equal(f"M1 L={L} layout {i}", a, b)
                states = iter([smoke.multiball_state(X, y, L, c_inv) for _ in range(reps + 1)])
                times[i].append(smoke.time_ms(
                    lambda: multiball_scan(X[1:], y[1:], *next(states), c_inv, c_inv,
                                           smem_budget=budget), dev, reps))
        planned = multiball_plan(L, X.shape[1])
        for i, plan in enumerate(plans):
            ts = times[i]
            print(f"M1 L={L} stream staged {plan['x_smem']}, tables in shared memory "
                  f"{plan['tables_smem']}{' (planned)' if plan == planned else ''}: "
                  f"{np.median(ts):.4f} ms a fit ({min(ts):.4f}-{max(ts):.4f}), bit-equal")
    n = X.shape[0] - 1
    Xp, yp = ops._pad_to(X[1:], 256, 0), ops._pad_to(y[1:], 256, 0)
    args = (Xp, yp, y[0] * X[0], 0.0, c_inv, c_inv, 1, c_inv)
    ms = smoke.time_ms(lambda: streamsvm_scan(*args, n_valid=n), dev, reps)
    print(f"B4 over the same {n} rows: {ms:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
