"""Quickstart on the PyTorch/CUDA port: one-pass StreamSVM against the
single-pass baselines on Synthetic-A, a whole C-grid in ONE pass, a 600-model
class x C-grid bank in one pass (and again with ``bank_resident="hbm"``, bit
for bit), and the bank served back through ``serve.BankServer``.

    PYTHONPATH=src python examples/torch_quickstart.py                 # on a card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --n-train 2000 --classes 8 --bank-n 300 --bank-d 16          # small, CPU

The flow of examples/quickstart.py on the port: Algorithm 1 (kernel B4) and
Algorithm 2 with a 10-row lookahead (B3); the perceptron (P1) and Pegasos
with k = 20 (P2); the C-grid as a bank of 5 models in one stream pass (B1);
a --classes x 3-point C-grid bank over --bank-n rows (B1 with a bf16
stream), trained again through the ring (B6) and asserted bit-equal; and
that bank served (ovr, B2), asserted equal to ``core.predict_c_grid``'s
class ids wherever the margins are not tied. ``main(argv)`` returns the
numbers it prints.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.baselines import fit_pegasos, fit_perceptron
from repro_torch.core import fit, fit_bank, fit_c_grid, fit_lookahead, ovr_signs, predict_c_grid
from repro_torch.data import load_dataset, preprocess_for
from repro_torch.serve import BankServer


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-train", type=int, default=None,
                    help="Synthetic-A's first rows to train on (default: all 20,000)")
    ap.add_argument("--classes", type=int, default=200)
    ap.add_argument("--bank-n", type=int, default=2000)
    ap.add_argument("--bank-d", type=int, default=64)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out = {}

    Xtr, ytr, Xte, yte = load_dataset("synthetic_a")
    Xtr, Xte = preprocess_for("synthetic_a", Xtr, Xte)
    Xtr, ytr = Xtr[: args.n_train], ytr[: args.n_train]
    X, y = torch.as_tensor(Xtr, device=dev), torch.as_tensor(ytr, device=dev)
    acc = lambda w: float(np.mean(np.sign(Xte @ w.double().cpu().numpy()) == yte)) * 100

    C = 10.0
    ball = fit(X, y, C)  # Algorithm 1: one pass, O(D) state
    ball2 = fit_lookahead(X, y, C, 10)  # Algorithm 2: lookahead 10
    wp, n_upd = fit_perceptron(X, y)
    wpeg = fit_pegasos(X, y, lam=1.0 / (C * len(ytr)), k=20)
    out["acc"] = {"algo1": acc(ball.w), "algo2": acc(ball2.w), "perceptron": acc(wp),
                  "pegasos20": acc(wpeg)}
    print(f"StreamSVM Algo-1 : {out['acc']['algo1']:5.1f}%  (core vectors: {int(ball.m)})")
    print(f"StreamSVM Algo-2 : {out['acc']['algo2']:5.1f}%  (core vectors: {int(ball2.m)})")
    print(f"Perceptron       : {out['acc']['perceptron']:5.1f}%  ({int(n_upd)} updates)")
    print(f"Pegasos k=20     : {out['acc']['pegasos20']:5.1f}%")
    print(f"ball radius R={float(ball.r):.3f}  xi2={float(ball.xi2):.4f}  "
          f"state = {ball.w.nbytes + 12} bytes (constant in N)")

    # --- hyper-parameter grid in ONE pass (the bank engine, B1) -----------
    grid = torch.tensor([0.1, 1.0, 10.0, 100.0, 1000.0], device=dev)
    fit_c_grid(X, y, grid)  # warm-up: the kernels load at first use
    sync(dev)
    t0 = time.perf_counter()
    bank = fit_c_grid(X, y, grid)
    sync(dev)
    dt = time.perf_counter() - t0
    accs = [acc(bank.w[i]) for i in range(len(grid))]
    print(f"\nC-grid in one pass ({len(grid)} models, {dt * 1e3:.1f} ms):")
    for i, c in enumerate(grid.tolist()):
        print(f"  C={c:7.1f}  acc={accs[i]:5.1f}%  core vectors={int(bank.m[i])}")
    best = int(np.argmax(accs))
    out["c_star"] = float(grid[best])
    print(f"selected C* = {out['c_star']:g} — one stream read for the whole grid "
          f"(state O(B*D) = {bank.w.nbytes} bytes)")

    # --- class x C-grid bank: many models, ONE pass ------------------------
    n_classes, c_pts = args.classes, (1.0, 10.0, 100.0)
    rng = np.random.default_rng(0)
    proto = rng.normal(size=(n_classes, args.bank_d)).astype(np.float32) * 3
    labels = rng.integers(0, n_classes, size=args.bank_n)
    Xm = (rng.normal(size=(args.bank_n, args.bank_d)) + proto[labels]).astype(np.float32)
    Xm /= np.linalg.norm(Xm, axis=1, keepdims=True)
    Xm = torch.as_tensor(Xm, device=dev)
    signs = ovr_signs(labels, n_classes, device=dev)  # (n_classes, N)
    Y = signs.repeat(len(c_pts), 1)  # class-major per C point
    cs = torch.repeat_interleave(torch.tensor(c_pts, device=dev), n_classes)
    fit_bank(Xm, Y, cs, b_tile=64, stream_dtype="bf16")  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    ovr = fit_bank(Xm, Y, cs, b_tile=64, stream_dtype="bf16")
    sync(dev)
    dt = time.perf_counter() - t0
    B, N = Y.shape
    out["bank_models"], out["bank_fit_s"] = B, dt
    print(f"\n{n_classes}-class OVR x {len(c_pts)}-point C-grid: {B} models, ONE {N}-row "
          f"stream pass in {dt * 1e3:.1f} ms ({B * N / dt / 1e6:.1f}M model-row updates/s)")
    m = ovr.m.cpu().numpy()
    for ci, cval in enumerate(c_pts):
        mc = m[ci * n_classes : (ci + 1) * n_classes]
        print(f"  C={cval:6.1f}  core vectors/model: min={mc.min()} mean={mc.mean():.1f} "
              f"max={mc.max()}")

    # --- the same bank, through the ring ------------------------------------
    ovr_hbm = fit_bank(Xm, Y, cs, b_tile=64, stream_dtype="bf16", bank_resident="hbm")
    for leaf in ("w", "r", "xi2", "m"):
        assert torch.equal(getattr(ovr_hbm, leaf), getattr(ovr, leaf)), leaf
    print('bank_resident="hbm": the ring (B6) gives the bank bit for bit')

    # --- serve it -----------------------------------------------------------
    server = BankServer(ovr, epilogue="ovr", n_classes=n_classes, q_block=256, b_tile=200)
    server.score(Xm[:1])  # warm-up
    steps0 = server.stats.steps
    t0 = time.perf_counter()
    cls, margins = server.score(Xm)
    dt = time.perf_counter() - t0
    direct_cls, _ = predict_c_grid(ovr, Xm, n_classes)
    direct_cls = direct_cls.cpu().numpy()
    # ids equal wherever a query's top two margins are not tied (the direct
    # readout sums in another order)
    scores = (Xm @ ovr.w.T).reshape(N, len(c_pts), n_classes).sort(dim=-1, descending=True).values
    gap = (scores[..., 0] - scores[..., 1]).cpu().numpy()
    sep = gap > 1e-5 * float(scores.abs().max())
    agree = bool(np.all((cls == direct_cls) | ~sep))
    assert agree, "served ids differ from predict_c_grid where the margins are separated"
    served = np.mean(cls == labels[:, None], axis=0)
    out["served_acc"] = served.tolist()
    out["served_steps"] = server.stats.steps - steps0
    print(f"\nserved the bank back over the {N} training rows in {out['served_steps']} "
          f"microbatches ({dt * 1e3:.1f} ms, {N / dt:.0f} queries/s):")
    for ci, cval in enumerate(c_pts):
        print(f"  C={cval:6.1f}  served acc={100 * served[ci]:5.1f}%")
    print(f"served == predict_c_grid wherever the margins are separated: {agree}")
    return out


if __name__ == "__main__":
    main()
