#!/usr/bin/env python3
"""Time LASVM's passes on the card in one checkout.

    python3 tools/ab_lasvm.py ROOT      # on a machine with a CUDA card

ROOT is the root of a checkout of this repository: its ``src/`` is put first
on the import path. So two versions compare on one card by running this once
per checkout, in turns (parent, change, change, parent). For synthetic_b
(D = 3, the most support vectors), mnist89 (D = 784) and ijcnn (D = 23),
in Table 1's first stream order at seed 0, it times chip_smoke.py phase 11's
LASVM calls: C = 1 and C = 10 on the first 2,000 rows, then the first 8,000
rows at C = 1 (the C phase 11 picks on these three).
Prints one line a dataset (each call's seconds and n_sv, and their sum) and
the checkout's total.
"""
import sys
import time

DATASETS = ("synthetic_b", "mnist89", "ijcnn")


def main(root):
    sys.path.insert(0, f"{root}/src")
    import torch
    from repro_torch.baselines import fit_lasvm
    from repro_torch.data import load_dataset, permuted, preprocess_for

    if not torch.cuda.is_available():
        sys.exit("ab_lasvm.py: no CUDA card")
    dev = torch.device("cuda")
    total = 0.0
    for name in DATASETS:
        Xtr, ytr, Xte, _ = load_dataset(name, seed=0)
        Xtr, _ = preprocess_for(name, Xtr, Xte)
        Xtr, ytr = permuted(Xtr, ytr, seed=0)
        X, y = torch.as_tensor(Xtr, device=dev), torch.as_tensor(ytr, device=dev)
        calls = [(2000, 1.0), (2000, 10.0), (8000, 1.0)]
        secs, nsv = [], []
        for rows, c in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, n_sv = fit_lasvm(X[:rows], y[:rows], C=c, return_bias=True)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            nsv.append(n_sv)
        total += sum(secs)
        print(f"{root} {name}: " + ", ".join(
            f"{min(rows, len(y))} rows C={c:g} {s:.3f} s (n_sv {n})"
            for (rows, c), s, n in zip(calls, secs, nsv)) + f"; {sum(secs):.3f} s")
    print(f"{root} total {total:.3f} s")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
