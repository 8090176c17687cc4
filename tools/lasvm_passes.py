#!/usr/bin/env python3
"""LASVM's pass on the card against the same pass on the host's CPU.

    python3 tools/lasvm_passes.py [--datasets synthetic_b,ijcnn] [--rows 8000]
        [--form fixed|blas]                  # on a machine with a CUDA card

For each dataset, Table 1's first stream order at seed 0 and its first
``--rows`` rows (phase 11's LASVM cap), LASVM with phase 11's C (10 on
synthetic_a, else 1) runs on the card and on the host's CPU with every
search recorded (``lasvm_searches``). Prints n_sv, w's largest
difference, and the first search whose picks differ (its row, both passes'
gradients of the two picks and their search bounds) with how far the
passes' w had drifted apart before it; else the largest drift of w over the
searches. ``--form fixed`` is the port's LASVM (every dot product summed in
``baselines.lasvm.halve``'s fixed pairwise order); ``--form blas`` replaces
those sums by ``torch.sum`` over the products, whose order is each
device's own, to show what the fixed order removes.
"""
import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.baselines import fit_lasvm  # noqa: E402
from repro_torch.baselines import lasvm as lasvm_mod  # noqa: E402
from repro_torch.data import load_dataset, permuted, preprocess_for  # noqa: E402


def lasvm_searches(X, y, C):
    """fit_lasvm(X, y, C) with every search recorded: per call of
    ``first_extreme``, the candidates' rows (S), their gradients (V, up's and
    down's negated), the bound, the picks and w, on the host. It reads
    ``extremes``' locals ``k``, ``Sv`` and ``w`` (the pass's search in
    ``baselines/lasvm.py``) and fails if one is missing."""
    real, rec = lasvm_mod.first_extreme, []

    def record(V, bound):
        e, idx = real(V, bound)
        f = sys._getframe(1).f_locals
        missing = {"k", "Sv", "w"} - set(f)
        if missing:
            raise RuntimeError(f"fit_lasvm's search has no local {sorted(missing)}")
        rec.append(dict(k=int(f["k"]), S=f["Sv"].cpu().clone(), V=V.cpu().clone(),
                        bound=float(bound), idx=idx.cpu().clone(), e=e.cpu().clone(),
                        w=f["w"].cpu().clone()))  # Sv is a view of the pass's buffer
        return e, idx

    lasvm_mod.first_extreme = record
    try:
        fit_lasvm(X, y, C=C, return_bias=True)
    finally:
        lasvm_mod.first_extreme = real
    return rec


def first_difference(host, card):
    for i, (a, b) in enumerate(zip(host, card)):
        pa = [int(a["S"][int(a["idx"][s])]) if torch.isfinite(a["e"][s]) else None for s in (0, 1)]
        pb = [int(b["S"][int(b["idx"][s])]) if torch.isfinite(b["e"][s]) else None for s in (0, 1)]
        if pa != pb or a["k"] != b["k"] or not torch.equal(a["S"], b["S"]):
            return i, a, b, pa, pb
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--datasets", default="synthetic_b")
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--form", default="fixed", choices=("fixed", "blas"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tools/lasvm_passes.py needs a CUDA card")
    if args.form == "blas":
        lasvm_mod.halve = lambda P: P.sum(-1)
    dev = torch.device("cuda")
    for name in args.datasets.split(","):
        Xtr0, ytr0, Xte, _ = load_dataset(name, seed=0)
        Xtr0, _ = preprocess_for(name, Xtr0, Xte)
        Xp0, yp0 = permuted(Xtr0, ytr0, seed=0)
        X = torch.as_tensor(Xp0[: args.rows], device=dev)
        y = torch.as_tensor(yp0[: args.rows], device=dev)
        c = 10.0 if name == "synthetic_a" else 1.0
        (wk, bk, nk), (wc, bc, nc) = (fit_lasvm(Xx, yx, C=c, return_bias=True)
                                      for Xx, yx in ((X, y), (X.cpu(), y.cpu())))
        err = float((wk.cpu() - wc).abs().max())
        print(f"{name} ({args.form} sums, {len(y)} rows, C={c:g}): n_sv card {nk}, CPU {nc}; w "
              f"max|diff| {err:.3e}; b {bk!r} / {bc!r}")
        card, host = lasvm_searches(X, y, c), lasvm_searches(X.cpu(), y.cpu(), c)
        diff = first_difference(host, card)
        if diff is None:
            drift = max(float((a["w"] - b["w"]).abs().max()) for a, b in zip(host, card))
            print(f"  {len(host)} / {len(card)} searches, no pick differs; w drifts at most "
                  f"{drift:.3e} apart")
            continue
        i, a, b, pa, pb = diff
        drift = float((a["w"] - b["w"]).abs().max()) / float(a["w"].abs().max())
        print(f"  the first search whose picks differ: {i} (row {a['k']} / {b['k']}), picks CPU "
              f"{pa}, card {pb}; w already {drift:.3e} apart (relative)")
        for s in (0, 1):
            ra, rb = pa[s], pb[s]
            la, lb = a["S"].tolist(), b["S"].tolist()
            if ra != rb and None not in (ra, rb) and {ra, rb} <= set(la) & set(lb):
                print(f"  side {('up', 'down')[s]}: CPU gradients {float(a['V'][s, la.index(ra)])!r}, "
                      f"{float(a['V'][s, la.index(rb)])!r}; card {float(b['V'][s, lb.index(ra)])!r}, "
                      f"{float(b['V'][s, lb.index(rb)])!r}; search bounds {a['bound']:.3e}, "
                      f"{b['bound']:.3e}")


if __name__ == "__main__":
    main()
