#!/usr/bin/env python3
"""Time every layout of M1 on benchmarks/beyond.py's stream, beside B4.

    PYTHONPATH=src python3 tools/multiball_layouts.py      # on a machine with a CUDA card

First the grid's exchange (the barrier of one update): microseconds of one,
at the grid layout's CTAs and shared memory. Then, on mnist89 (11,800 x 784,
C = 10), for L = 1, 2, 4, 8: every layout ``kernels.multiball.multiball_layouts``
reaches (the grid, each one-CTA layout below its bytes; each forced by a
budget of its own bytes), the grid capped at 30, 23 and 15 rows a CTA (3, 4
and 6 windows; each forced by a budget of its own bytes), and the one-CTA
layout with the stream staged and the tables in shared memory (the plan's
first before the grid; launched through ``_launch``, since the plan no
longer reaches it at this size). Each
is checked bit-equal to the plain version and timed in turns over 3 rounds,
each round a mean over 10 launches on fresh copies of the seeded state, two
ways: CUDA events around launches back to back (``ms``, which the wrapper's
host time may pace) and the same launches queued behind a spin (the card
alone). Then B4 (Algorithm 1, one model) over the same rows. Prints one line
a layout with the rounds' median and range, and the card's name and power
limit.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def exchange_us(n_ctas, smem, k=2000, reps=5):
    """Microseconds of one grid exchange of M1's grid layout (its barrier,
    which also reduces) on the card: k of them on n_ctas CTAs with smem
    bytes of shared memory each, less an empty launch, by CUDA events
    (median of reps)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import multiball as mb

    lib = mb._lib()
    posts = torch.empty(lib.multiball_grid_scratch_bytes(0, n_ctas), device="cuda",
                        dtype=torch.uint8)
    stream = torch.cuda.current_stream().cuda_stream

    def run(kk):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        _build.check(lib.multiball_grid_barriers(posts.data_ptr(), n_ctas, kk, smem, stream),
                     "multiball_grid_barriers")
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    run(k)
    times = sorted(run(k) - run(0) for _ in range(reps))
    return times[len(times) // 2] * 1e3 / k


def main():
    from repro_torch.data import load_dataset, preprocess_for
    from repro_torch.kernels import multiball as mb
    from repro_torch.kernels import ops
    from repro_torch.kernels.streamsvm_scan import sm_count, streamsvm_scan

    dev = torch.device("cuda")
    Xtr, ytr, _, _ = load_dataset("mnist89")
    Xtr, _ = preprocess_for("mnist89", Xtr, Xtr[:1])
    X, y = torch.as_tensor(Xtr, device=dev), torch.as_tensor(ytr, device=dev)
    n, d = X.shape[0] - 1, X.shape[1]
    c_inv = float(np.float32(0.1))
    reps, rounds = 10, 3
    grid8 = mb.multiball_plan(8, d, n=n)
    print(f"grid exchange: {exchange_us(sm_count(), sum(grid8['smem'].values())):.3f} us "
          f"at {sm_count()} CTAs with {sum(grid8['smem'].values())} B each "
          f"({exchange_us(sm_count(), 0):.3f} us with none)")
    for L in (1, 2, 4, 8):
        plans = mb.multiball_layouts(L, d, n=n)
        for rows in (30, 23, 15):
            plans.append(mb.multiball_plan(L, d, n=n,
                                           smem_budget=sum(mb.grid_smem(d, L, rows).values())))
        staged = mb.cta_plan(L, d, True, True)
        if staged not in plans:
            plans.append(staged)
        want = smoke.run_multiball(mb.multiball_scan_plain, X, y, L, c_inv, c_inv)
        times = {i: ([], []) for i in range(len(plans))}
        for _ in range(rounds):
            for i, plan in enumerate(plans):
                launch = lambda st, plan=plan: mb._launch(plan, X[1:], y[1:], *st, c_inv, c_inv)
                got = smoke.multiball_state(X, y, L, c_inv)
                launch(got)
                for a, b in zip(got, want):
                    smoke.bit_equal(f"M1 L={L} {smoke.multiball_note(plan)}", a, b)
                for k, card in enumerate((False, True)):
                    states = [smoke.multiball_state(X, y, L, c_inv) for _ in range(reps + 1)]
                    times[i][k].append(smoke.time_states_ms(launch, states, dev, card_only=card))
        planned = mb.multiball_plan(L, d, n=n)
        for i, plan in enumerate(plans):
            ev, card = times[i]
            print(f"M1 L={L} {smoke.multiball_note(plan)}{' (planned)' if plan == planned else ''}: "
                  f"{np.median(ev):.4f} ms a fit by events ({min(ev):.4f}-{max(ev):.4f}), "
                  f"{np.median(card):.4f} on the card alone ({min(card):.4f}-{max(card):.4f}), "
                  "bit-equal")
    Xp, yp = ops._pad_to(X[1:], 256, 0), ops._pad_to(y[1:], 256, 0)
    args = (Xp, yp, y[0] * X[0], 0.0, c_inv, c_inv, 1, c_inv)
    ms = smoke.time_ms(lambda: streamsvm_scan(*args, n_valid=n), dev, reps)
    print(f"B4 over the same {n} rows: {ms:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
