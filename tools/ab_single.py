#!/usr/bin/env python3
"""Time B4, P1 and P2 on one stream in one checkout.

    python3 tools/ab_single.py ROOT      # on a machine with a CUDA card

ROOT is the root of a checkout of this repository: its ``src/`` is put first
on the import path, while the stream and the timers are ``chip_smoke.py``'s
(this script's checkout). So two versions compare on one card by running
this once per checkout, in turns (parent, change, change, parent). On
mnist89 (11,800 x 784) in Table 1's first stream order at seed 0 it times
B4 (``streamsvm_scan``, Algorithm 1 at C = 10), P1 (``perceptron_scan``) and
P2 (``pegasos_scan`` at k = 1 and 20, Table 1's lambda 1 / (100 N)), each in
its checkout's planned layout: 4 launches back to back after one, by
CUDA events and the same launches queued behind a spin (the card alone);
the median of 9 such rounds each. Prints one line: the checkout and the two
milliseconds of each kernel.
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

ROUNDS, REPS = 9, 4


def main(root):
    sys.path.insert(0, f"{root}/src")
    from repro_torch.data import load_dataset, permuted, preprocess_for
    from repro_torch.kernels import ops
    from repro_torch.kernels.baselines import pegasos_scan, perceptron_scan
    from repro_torch.kernels.streamsvm_scan import streamsvm_scan

    if not torch.cuda.is_available():
        sys.exit("ab_single.py: no CUDA card")
    dev = torch.device("cuda")
    Xtr, ytr, Xte, _ = load_dataset("mnist89", seed=0)
    Xtr, _ = preprocess_for("mnist89", Xtr, Xte)
    Xtr, ytr = permuted(Xtr, ytr, seed=0)
    X, y = torch.as_tensor(Xtr, device=dev), torch.as_tensor(ytr, device=dev)
    n = len(y)
    # B4's scalars as device tensors: a host scalar is copied to the card on
    # each call, and that copy would wait behind the spin.
    c_inv = torch.tensor(0.1, device=dev)
    Xp, yp = ops._pad_to(X[1:], 256, 0), ops._pad_to(y[1:], 256, 0)
    b4 = (Xp, yp, y[0] * X[0], torch.zeros((), device=dev), c_inv, c_inv,
          torch.ones((), dtype=torch.int32, device=dev), c_inv)
    lam = 1.0 / (100.0 * n)
    calls = {
        "B4": lambda: streamsvm_scan(*b4, n_valid=n - 1),
        "P1": lambda: perceptron_scan(X, y),
        "P2 k=1": lambda: pegasos_scan(X, y, lam, 1),
        "P2 k=20": lambda: pegasos_scan(X, y, lam, 20),
    }
    out = []
    for name, call in calls.items():
        ev, card = (float(np.median([smoke.time_states_ms(lambda _: call(), [None] * (REPS + 1),
                                                          dev, alone)
                                     for _ in range(ROUNDS)]))
                    for alone in (False, True))
        out.append(f"{name} {ev:.4f} / {card:.4f}")
    print(root, "(ms by events / on the card alone):", "; ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
