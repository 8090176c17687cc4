"""Live bank on the PyTorch/CUDA port: always-on ingest -> train -> fold ->
hot-swap, crashes included.

    PYTHONPATH=src python examples/torch_live_bank.py                  # on a card
    PYTHONPATH=src python examples/torch_live_bank.py --device cpu \\
        --n-chunks 20 --chunk 64 --ring-chunks 6 --ring-chunk 64          # small, CPU

The flow of examples/live_bank.py on the port. A drifting stream (class
prototypes rotate a little every chunk) feeds a ``repro_torch.live.LiveBank``:
each chunk trains into the active sub-bank (kernel B1), the K rotating
sub-banks fold with the Sec-4.3 merge into one serving bank, and every fold
hot-swaps a running ``BankServer`` (kernel B2), which answers queries the
whole time.

Then the same stream again with crashes at four phase boundaries (mid-chunk,
between fold and swap, mid-checkpoint-commit, after a swap), transient fetch
faults and one poison chunk: the recovery loop restarts from the atomic
checkpoint each time, and the final bank and served scores are bit-identical
to a crash-free run with the same source faults (asserted).

Elastic: four logical stream shards (``n_stream_shards=4``) on ``--ranks``
gloo ranks that run the loop SPMD over a DeviceMesh (each rank on
``--device``; rank 0 writes the checkpoints). The run is killed at one chunk
on every rank; this process resumes it without a mesh, adopting the
checkpoint's 4 shards, and the result equals the crash-free one-process run
with 4 shards bit for bit, with one remesh counted (asserted).

Last, the kernelized live loop (``bank_kind="kernel"``, kernels B5 and R1)
on drifting concentric rings, which no linear bank separates, with the same
crash-recovery claim asserted on the core-set buffers and the served RBF
scores.
"""
import argparse
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import ovr_signs
from repro_torch.live import ArraySource, FlakySource, LiveBank, run_live_with_restarts
from repro_torch.runtime import InjectedFailure
from repro_torch.serve import BankServer

C_PTS = (1.0, 10.0)
NOSLEEP = lambda s: None  # the example does not back off for real
ELASTIC_KILL = ("post_train", 7)


def drifting_stream(n_chunks, chunk, d, n_classes, seed=0):
    """(X, labels) whose class prototypes rotate slowly chunk over chunk."""
    rng = np.random.default_rng(seed)
    proto = rng.normal(size=(n_classes, d)).astype(np.float32) * 3
    drift = rng.normal(size=(n_classes, d)).astype(np.float32) * 0.15
    Xs, ys = [], []
    for t in range(n_chunks):
        labels = rng.integers(0, n_classes, size=chunk)
        X = rng.normal(size=(chunk, d)).astype(np.float32) + (proto + t * drift)[labels]
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        Xs.append(X)
        ys.append(labels)
    return np.concatenate(Xs), np.concatenate(ys)


def drifting_rings(n_chunks, chunk, seed=1):
    """Binary concentric rings whose radii drift chunk over chunk."""
    rng = np.random.default_rng(seed)
    Xs, ys = [], []
    for t in range(n_chunks):
        y = np.where(rng.uniform(size=chunk) < 0.5, 1.0, -1.0)
        rad = np.where(y > 0, 1.0, 2.5) + 0.05 * t
        ang = rng.uniform(0, 2 * np.pi, size=chunk)
        X = rng.normal(scale=0.1, size=(chunk, 2)).astype(np.float32)
        X[:, 0] += (rad * np.cos(ang)).astype(np.float32)
        X[:, 1] += (rad * np.sin(ang)).astype(np.float32)
        Xs.append(X)
        ys.append(y.astype(np.float32))
    return np.concatenate(Xs), np.tile(np.concatenate(ys), (2, 1))


def linear_stream(args):
    X, labels = drifting_stream(args.n_chunks, args.chunk, args.d, args.classes)
    Y = np.tile(ovr_signs(labels, args.classes, device="cpu").numpy(), (len(C_PTS), 1))
    return X, labels, Y


def make_live(args, source, ckpt_dir, device, **kw):
    cs = np.repeat(np.asarray(C_PTS, np.float32), args.classes)
    return LiveBank(
        source, cs, ckpt_dir=ckpt_dir, n_sub_banks=3, rotate_every=4, swap_every=2,
        b_tile=8, sleep=NOSLEEP, device=device,
        server_factory=lambda bank: BankServer(bank, epilogue="ovr", n_classes=args.classes,
                                               q_block=128, device=device),
        **kw,
    )


def make_kernel_live(args, source, ckpt_dir, device, **kw):
    return LiveBank(
        source, np.asarray([0.5, 5.0], np.float32), ckpt_dir=ckpt_dir, bank_kind="kernel",
        kernel="rbf", gamma=2.0, coreset_size=args.coreset, n_sub_banks=2, rotate_every=4,
        swap_every=2, sleep=NOSLEEP, device=device,
        server_factory=lambda bank: BankServer(bank, kernel="rbf", gamma=2.0, q_block=64,
                                               device=device),
        **kw,
    )


def bank_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _elastic_rank(rank, world, store, args):
    """One rank of the elastic run: the loop SPMD over a DeviceMesh, killed
    at ELASTIC_KILL on every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}/pg", rank=rank,
                            world_size=world)
    try:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        X, _, Y = linear_stream(args)
        live = make_live(args, ArraySource(X, Y, args.chunk), f"{store}/ce", args.device,
                         n_stream_shards=4, mesh=mesh, failpoints=[ELASTIC_KILL])
        try:
            live.run()
        except InjectedFailure:
            return
        raise AssertionError("the injected kill never fired")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-chunks", type=int, default=24)
    ap.add_argument("--chunk", type=int, default=200, help="rows a chunk")
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=2, help="gloo ranks of the elastic run")
    ap.add_argument("--ring-chunks", type=int, default=12)
    ap.add_argument("--ring-chunk", type=int, default=128)
    ap.add_argument("--coreset", type=int, default=32, help="S of the kernel bank")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: pass --device cpu")
    if args.n_chunks < 20:
        raise SystemExit("--n-chunks must be at least 20 (the crash plan reaches chunk 19)")
    dev = torch.device(args.device)
    X, labels, Y = linear_stream(args)
    queries = X[-256:]
    poison = {3: 2, 15: FlakySource.POISON}  # 2 transient faults on chunk 3, chunk 15 poison

    # --- uninterrupted run ------------------------------------------------
    with tempfile.TemporaryDirectory() as td:
        live = make_live(args, ArraySource(X, Y, args.chunk), td + "/c", dev)
        stats = live.run()
    print(f"clean run: {stats.chunks_ingested} chunks / {stats.rows_ingested} rows -> "
          f"{stats.folds} folds, {stats.swaps} hot-swaps, {stats.rotations} rotations "
          f"({stats.retirements} retirements), {stats.checkpoints} checkpoints; serving bank "
          f"{tuple(live.serving_bank().w.shape)}")

    # --- the same stream, hostile infrastructure ----------------------------
    failpoints = [("post_train", 5), ("post_fold", 9), ("mid_checkpoint", 13),
                  ("post_swap", 19)]
    with tempfile.TemporaryDirectory() as td:
        crashy = make_live(args, FlakySource(ArraySource(X, Y, args.chunk), poison), td + "/c",
                           dev, failpoints=failpoints)
        stats2 = run_live_with_restarts(crashy, sleep=NOSLEEP)
        cls, _ = crashy.server.score(queries)
    # the referent: the same source faults (a quarantined chunk keeps its
    # stream position, so epochs line up), no crashes
    with tempfile.TemporaryDirectory() as td:
        ref = make_live(args, FlakySource(ArraySource(X, Y, args.chunk), poison), td + "/c", dev)
        ref.run()
        qcls, _ = ref.server.score(queries)
    assert bank_equal(crashy.serving_bank(), ref.serving_bank()), "recovered bank diverged"
    assert np.array_equal(cls, qcls) and stats2.durable() == ref.stats.durable()
    acc = float(np.mean(cls[:, 0] == labels[-256:]))
    print(f"crashy run: {stats2.restarts} restarts, {stats2.retries} fetch retries, quarantined "
          f"chunks {stats2.quarantined}; bank, served ids and durable stats bit-identical to the "
          f"crash-free run; served accuracy on the freshest chunk {100 * acc:.1f}% (C={C_PTS[0]})")

    # --- elastic: 4 logical shards on the ranks, killed, resumed here ------
    with tempfile.TemporaryDirectory() as td:
        ref = make_live(args, ArraySource(X, Y, args.chunk), td + "/cs", dev, n_stream_shards=4)
        ref.run()
        mp.spawn(_elastic_rank, args=(args.ranks, td, args), nprocs=args.ranks, join=True)
        resumed = make_live(args, ArraySource(X, Y, args.chunk), td + "/ce", dev)
        estats = resumed.run()
        assert resumed.n_stream_shards == 4, "the checkpoint's shard count was not adopted"
        assert estats.remeshes == 1
        assert bank_equal(resumed.serving_bank(), ref.serving_bank()), "the remesh changed the bank"
        assert np.array_equal(resumed.server.score(queries)[0], ref.server.score(queries)[0])
    print(f"elastic run: 4 logical shards on {args.ranks} SPMD ranks, killed at chunk "
          f"{ELASTIC_KILL[1]}, resumed in one process without a mesh ({estats.remeshes} remesh); "
          "bank and served ids bit-identical to the one-process run")

    # --- the kernelized live loop: drifting rings ---------------------------
    Xr, Yr = drifting_rings(args.ring_chunks, args.ring_chunk)
    rq = Xr[-args.ring_chunk:]
    with tempfile.TemporaryDirectory() as td:
        live_k = make_kernel_live(args, ArraySource(Xr, Yr, args.ring_chunk), td + "/ck", dev)
        kstats = live_k.run()
        kref = live_k.server.score(rq)
    with tempfile.TemporaryDirectory() as td:
        live_k2 = make_kernel_live(args, ArraySource(Xr, Yr, args.ring_chunk), td + "/ck", dev,
                                   failpoints=[("post_train", 3), ("mid_checkpoint", 5),
                                               ("post_fold", 3)])
        kstats2 = run_live_with_restarts(live_k2, sleep=NOSLEEP)
        kscores2 = live_k2.server.score(rq)
    assert bank_equal(live_k.serving_bank(), live_k2.serving_bank()), "kernel bank diverged"
    assert np.array_equal(kref, kscores2)
    assert kstats2.durable() == kstats.durable()
    acc_k = float(np.mean(np.sign(kref[:, 1]) == Yr[0, -args.ring_chunk:]))
    print(f"kernel loop: {kstats.chunks_ingested} ring chunks -> {kstats.folds} folds, core-set "
          f"bank {tuple(live_k.serving_bank().points.shape)}, dropped |coef| mass "
          f"{kstats.merge_dropped_mass:.4f}; {kstats2.restarts} crashes bit-identical; accuracy "
          f"on the freshest ring chunk {100 * acc_k:.1f}%")
    return {"restarts": stats2.restarts, "quarantined": stats2.quarantined,
            "remeshes": estats.remeshes, "kernel_restarts": kstats2.restarts,
            "acc": acc, "acc_rings": acc_k}


if __name__ == "__main__":
    main()
