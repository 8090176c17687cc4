"""Distributed one-pass StreamSVM on the PyTorch/CUDA port: sharded streams +
ball merge + C-grid, then the sharded bank engine (600 models).

    PYTHONPATH=src python examples/torch_svm_distributed.py             # 2 ranks, one card
    PYTHONPATH=src python examples/torch_svm_distributed.py --device cpu --ranks 2 \\
        --n-train 600 --n-bank 300 --classes 20                       # small, CPU

The flow of examples/svm_distributed.py on torch.distributed: ``--ranks``
processes (spawned here) join a gloo process group and a one-axis
DeviceMesh ("data"); every rank holds the whole stream, fits its range on
``--device`` and folds the gathered states with the Sec-4.3 merge. NCCL
takes one process a card, so ranks sharing one card use gloo; the folded
states then pass through host memory, once per stream. Steps: Algorithm 1
against ``fit_sharded(lookahead=10)`` on mnist89; ``fit_c_grid(mesh=)``;
and a 200-class x 3-point C-grid bank (600 models) over a ragged stream
through ``fit_bank_sharded`` with ``b_tile=64`` and a bf16 stream. Every
rank must end with the same bits (checked); rank 0 prints.
"""
import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import (
    accuracy,
    fit,
    fit_bank_sharded,
    fit_c_grid,
    fit_sharded,
    ovr_signs,
    predict_ovr,
)
from repro_torch.data import load_dataset, preprocess_for


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _same_on_every_rank(t: torch.Tensor) -> bool:
    host = t.detach().float().cpu().contiguous()
    out = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(out, host)
    return all(torch.equal(o, host) for o in out)


def _rank(rank, world, store, args):
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}/pg", rank=rank,
                            world_size=world)
    try:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        dev = torch.device(args.device)
        say = print if rank == 0 else (lambda *a, **k: None)
        Xtr, ytr, Xte, yte = load_dataset("mnist89")
        Xtr, Xte = preprocess_for("mnist89", Xtr, Xte)
        n = (min(len(ytr), args.n_train) // world) * world
        X, y = torch.as_tensor(Xtr[:n], device=dev), torch.as_tensor(ytr[:n], device=dev)
        Xt, yt = torch.as_tensor(Xte, device=dev), torch.as_tensor(yte, device=dev)
        say(f"ranks: {world}  mesh: {tuple(mesh.shape)}  device: {dev}")

        t0 = time.perf_counter()
        ball_seq = fit(X, y, 10.0)
        _sync(dev)
        t_seq = time.perf_counter() - t0
        t0 = time.perf_counter()
        ball_dist = fit_sharded(X, y, 10.0, mesh, lookahead=10)
        _sync(dev)
        t_dist = time.perf_counter() - t0
        acc_seq, acc_dist = float(accuracy(ball_seq, Xt, yt)), float(accuracy(ball_dist, Xt, yt))
        say(f"sequential  : acc={acc_seq * 100:5.2f}%  r={float(ball_seq.r):.3f}  ({t_seq:.2f}s)")
        say(f"{world}-shard+merge: acc={acc_dist * 100:5.2f}%  r={float(ball_dist.r):.3f}  "
            f"({t_dist:.2f}s)")

        # The whole C grid is a bank, and the stream is sharded over the mesh.
        grid = torch.tensor([0.1, 1.0, 10.0, 100.0], device=dev)
        balls = fit_c_grid(X, y, grid, mesh=mesh)
        grid_acc = [float(((Xt @ balls.w[i]) * yt > 0).float().mean()) for i in range(len(grid))]
        for c, a in zip(grid.tolist(), grid_acc):
            say(f"C={c:7.1f}: acc={a * 100:5.2f}%")

        # The sharded bank engine: classes x C-grid on the bank axis, the
        # ragged stream split into contiguous ranges (the last padded with
        # inert rows), one gather and the bank-wide Sec-4.3 fold.
        n_classes, c_pts = args.classes, (1.0, 10.0, 100.0)
        rng = np.random.default_rng(0)
        proto = rng.normal(size=(n_classes, 64)).astype(np.float32) * 3
        labels = rng.integers(0, n_classes, size=args.n_bank)
        Xm = (rng.normal(size=(args.n_bank, 64)) + proto[labels]).astype(np.float32)
        Xm /= np.linalg.norm(Xm, axis=1, keepdims=True)
        Xm = torch.as_tensor(Xm, device=dev)
        Y = ovr_signs(labels, n_classes, device=dev).repeat(len(c_pts), 1)
        cs = torch.tensor(c_pts, device=dev).repeat_interleave(n_classes)
        fit_bank_sharded(Xm, Y, cs, mesh, b_tile=64, stream_dtype="bf16")  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        ovr = fit_bank_sharded(Xm, Y, cs, mesh, b_tile=64, stream_dtype="bf16")
        _sync(dev)
        dt = time.perf_counter() - t0
        same = all(_same_on_every_rank(v) for v in (*ball_dist, *balls, *ovr))
        assert same, "the ranks' folded states differ"
        b = Y.shape[0]
        say(f"\nsharded bank: {b} models x {world} stream shards, N={args.n_bank} "
            f"(ragged; padded with inert rows) in {dt * 1e3:.0f} ms; every rank holds the "
            "same bits")
        m = ovr.m.cpu().numpy()
        bank_acc = []
        for ci, cval in enumerate(c_pts):
            blk = type(ovr)(*(v[ci * n_classes : (ci + 1) * n_classes] for v in ovr))
            acc = float((predict_ovr(blk, Xm).cpu().numpy() == labels).mean())
            bank_acc.append(acc)
            mc = m[ci * n_classes : (ci + 1) * n_classes]
            say(f"  C={cval:6.1f}  OVR train acc {acc * 100:5.1f}% (chance "
                f"{100 / n_classes:.1f}%)  core vectors/model: min={mc.min()} "
                f"mean={mc.mean():.1f} max={mc.max()}")
        if rank == 0:
            Path(store, "result.json").write_text(json.dumps({
                "acc_seq": acc_seq, "acc_dist": acc_dist, "grid_acc": grid_acc,
                "bank_acc": bank_acc, "bank_s": dt, "same": same}))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--n-train", type=int, default=11_800, help="mnist89 rows (at most 11,800)")
    ap.add_argument("--n-bank", type=int, default=2003, help="rows of the bank's ragged stream")
    ap.add_argument("--classes", type=int, default=200)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: pass --device cpu")
    with tempfile.TemporaryDirectory() as store:
        mp.spawn(_rank, args=(args.ranks, store, args), nprocs=args.ranks, join=True)
        return json.loads(Path(store, "result.json").read_text())


if __name__ == "__main__":
    main()
