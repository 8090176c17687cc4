"""Kernelized one-pass bank on the PyTorch/CUDA port: rings -> RBF core-set
bank -> serving.

    PYTHONPATH=src python examples/torch_kernel_bank.py                 # on a card
    PYTHONPATH=src python examples/torch_kernel_bank.py --device cpu \\
        --n-train 400 --n-test 150 --coreset 32                       # small, CPU

The flow of examples/kernel_bank.py on the port. Two concentric rings are
not linearly separable; ``core.fit_kernel_bank`` runs Algorithm 1 in kernel
space in one stream pass (kernels B5 for the Gram blocks and R1 for the
row recursion), each model keeping at most S core-set rows (state O(B S D),
independent of N) and evicting the smallest |coef| or the slot closest to
the center when full. ``s_tile=`` chunks the core-set Gram launch and gives
the same bits. The bank checkpoints through ``core.save_kernel_bank`` and
serves through ``BankServer``; served scores equal the direct
``core.kernel_bank_decision`` readout bit for bit (asserted). The stream
sharded over processes is examples/torch_svm_distributed.py's.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import fit_kernel_bank, kernel_bank_decision, save_kernel_bank
from repro_torch.serve import BankServer


def make_rings(n, d, seed):
    """Inner ring -> +1, outer ring -> -1; extra dims are noise."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0).astype(np.float32)
    radius = np.where(y > 0, 1.0, 2.5)
    theta = rng.uniform(0, 2 * np.pi, size=n)
    X = rng.normal(scale=0.1, size=(n, d)).astype(np.float32)
    X[:, 0] += (radius * np.cos(theta)).astype(np.float32)
    X[:, 1] += (radius * np.sin(theta)).astype(np.float32)
    return X, y


def bank_accuracy(bank, Xte, yte, *, kernel, gamma, dev):
    scores = kernel_bank_decision(bank, torch.as_tensor(Xte, device=dev), kernel=kernel,
                                  gamma=gamma).cpu().numpy()  # (Q, B)
    return [float(np.mean(np.sign(s) == yte)) for s in scores.T]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-train", type=int, default=1200)
    ap.add_argument("--n-test", type=int, default=400)
    ap.add_argument("--coreset", type=int, default=64, help="S, the core-set bound")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    c_pts, d, s_size, gamma = (0.5, 5.0, 50.0), 8, args.coreset, 2.0
    Xtr, ytr = make_rings(args.n_train, d, seed=0)
    Xte, yte = make_rings(args.n_test, d, seed=1)
    X = torch.as_tensor(Xtr, device=dev)
    Y = torch.as_tensor(ytr, device=dev)[None, :].repeat(len(c_pts), 1)  # (B, N)
    cs = torch.tensor(c_pts, device=dev)
    kw = dict(gamma=gamma, coreset_size=s_size, block_n=128)

    # --- one stream pass per kernel; identical API, only the epilogue flips
    banks = {}
    for kernel in ("linear", "rbf"):
        t0 = time.perf_counter()
        banks[kernel] = fit_kernel_bank(X, Y, cs, kernel=kernel, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_fit = time.perf_counter() - t0
        accs = bank_accuracy(banks[kernel], Xte, yte, kernel=kernel, gamma=gamma, dev=dev)
        kept = int(banks[kernel].m.max())
        print(f"{kernel:>6}: ONE {len(Xtr)}-row pass in {t_fit * 1e3:5.0f} ms on {dev}, buffer "
              f"S={s_size}, {kept} core-set updates; held-out acc "
              + ", ".join(f"C={c:4.1f}: {100 * a:5.1f}%" for c, a in zip(c_pts, accs)))
    best_rbf = max(bank_accuracy(banks["rbf"], Xte, yte, kernel="rbf", gamma=gamma, dev=dev))
    assert best_rbf > 0.9, f"RBF bank should separate the rings, got {best_rbf}"

    # --- eviction + s_tile: same pass, different slot policy / tiling ------
    bank_fp = fit_kernel_bank(X, Y, cs, kernel="rbf", eviction="farthest-point", **kw)
    best_fp = max(bank_accuracy(bank_fp, Xte, yte, kernel="rbf", gamma=gamma, dev=dev))
    bank_tiled = fit_kernel_bank(X, Y, cs, kernel="rbf", s_tile=max(1, s_size // 4), **kw)
    assert all(torch.equal(a, b) for a, b in zip(banks["rbf"], bank_tiled)), \
        "s_tile chunking must be bit-exact"
    print(f"eviction sweep: smallest-coef {100 * best_rbf:5.1f}% vs farthest-point "
          f"{100 * best_fp:5.1f}% held-out acc; s_tile={max(1, s_size // 4)} refit is BIT-EXACT "
          "with the unchunked bank (7/7 leaves)")

    with tempfile.TemporaryDirectory() as td:
        # --- checkpoint -> serve: meta carries bank_kind/kernel/gamma ------
        save_kernel_bank(td, banks["rbf"], kernel="rbf", gamma=gamma)
        server = BankServer.from_checkpoint(td, q_block=128, device=dev)
        print(f"serving core-set bank {server.bank_shape} from checkpoint "
              f"(kernel={server.kernel!r}, gamma={server.gamma} via meta)")
        rng = np.random.default_rng(7)
        reqs, lo = [], 0
        while lo < len(Xte):  # ragged client batches, FIFO-packed into slots
            n = int(rng.integers(1, 100))
            reqs.append(server.submit(Xte[lo : lo + n]))
            lo += n
        t0 = time.perf_counter()
        stats = server.run()
        t_serve = time.perf_counter() - t0

    served = np.concatenate([r.result for r in reqs])  # (Q, B) margins
    direct = kernel_bank_decision(banks["rbf"], torch.as_tensor(Xte, device=dev), kernel="rbf",
                                  gamma=gamma).cpu().numpy()
    assert np.array_equal(served, direct), "served kernel scores diverged"
    print(f"served {len(Xte)} queries x {len(c_pts)} models in {stats.steps} microbatches "
          f"({t_serve * 1e3:.0f} ms, {len(Xte) / t_serve:.0f} queries/s, slot utilization "
          f"{stats.utilization:.1%}); served f32 scores BIT-EXACT with "
          "core.kernel_bank_decision")

    # --- hot swap: continue the fit on fresh rows, serving keeps running --
    X2, y2 = make_rings(args.n_train // 2, d, seed=2)
    X12 = torch.as_tensor(np.concatenate([Xtr, X2]), device=dev)
    Y12 = torch.as_tensor(np.concatenate([ytr, y2]), device=dev)[None, :].repeat(len(c_pts), 1)
    bank2 = fit_kernel_bank(X12, Y12, cs, kernel="rbf", **kw)
    server.submit(Xte[:128])
    server.step()  # scores against the OLD bank
    server.swap_bank(bank2)  # queued requests survive the swap
    server.run()
    print(f"hot-swapped to the {len(X12)}-row bank mid-stream ({server.stats.bank_swaps} swap, "
          f"{server.stats.finished} requests finished, none dropped)")
    return {"best_rbf": best_rbf, "best_fp": best_fp}


if __name__ == "__main__":
    main()
