#!/usr/bin/env python3
"""Time phase 6b's kernelized-bank pass and one R1 tile in one checkout.

    python3 tools/ab_kernel_bank.py ROOT      # on a machine with a CUDA card

ROOT is the root of a checkout of this repository: its ``src/`` is put first
on the import path, while the stream, R1's inputs and their timing are
``chip_smoke.py``'s (this script's checkout). So two versions compare on one
card by running this once per checkout, in turns (parent, change, change,
parent, ...). On phase 6b's stream at chip_smoke.py's defaults it fits the
RBF bank (S = 64, block_n 256) once per eviction after a warm-up on its
first 8 tiles, and times R1 at tile 8 of the pass as phase 5 does
(``time_rows_ms``: 20 launches back to back after one, by CUDA events, and
the same launches queued behind a spin, the card alone). Prints one line:
the checkout, the fit seconds and the two R1 milliseconds per eviction.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402


def main(root):
    sys.path.insert(0, f"{root}/src")
    from repro_torch.core import fit_kernel_bank
    from repro_torch.kernels.kernel_bank import kernel_bank_rows

    if not torch.cuda.is_available():
        sys.exit("ab_kernel_bank.py: no CUDA card")
    dev = torch.device("cuda")
    kb = smoke.kb_stream(argparse.Namespace(seed=0, n_train=60_000, n_test=10_000, d=784,
                                            classes=200))
    Xd, Yd, csd = (torch.as_tensor(kb[k], device=dev) for k in ("X", "Y", "cs"))
    t = 8
    out = []
    for ev in ("smallest-coef", "farthest-point"):
        fit = lambda n: fit_kernel_bank(Xd[:n], Yd[:, :n], csd, kernel="rbf",
                                        gamma=smoke.KB_GAMMA, coreset_size=64, eviction=ev,
                                        block_n=256)
        st = fit(t * 256)  # the warm-up, and the state at tile t
        smoke.sync(dev)
        t0 = time.perf_counter()
        fit(len(kb["X"]))
        smoke.sync(dev)
        secs = time.perf_counter() - t0
        inp = smoke.rows_inputs(dev, kb, st, t, ev == "farthest-point")
        ms = smoke.time_rows_ms(kernel_bank_rows, inp, dev, 20)
        card_ms = smoke.time_rows_ms(kernel_bank_rows, inp, dev, 20, card_only=True)
        out.append(f"{ev}: fit {secs:.3f} s, R1 {ms:.4f} ms (the card alone {card_ms:.4f} ms)")
    print(root, "; ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
