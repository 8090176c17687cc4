"""Train -> checkpoint -> serve on the PyTorch/CUDA port: the 600-model bank.

    PYTHONPATH=src python examples/torch_serve_bank.py                 # on a card
    PYTHONPATH=src python examples/torch_serve_bank.py --device cpu \\
        --n-train 400 --n-test 120 --d 16 --classes 8                # small, CPU

The flow of examples/serve_bank.py on the port: one pass of kernel B1 fits
a class x C-grid bank (200 classes x 3 C points = 600 models by default)
through the chunked streaming driver with a bf16 stream, the bank is
checkpointed (state O(B * D)), and ``BankServer.from_checkpoint`` serves it:
ragged query batches packed into 256-row slots and scored by kernel B2 with
the per-C-grid-group argmax epilogue. Served results equal a direct
``kernels.ops.predict_bank`` call on the same bank bit for bit (asserted);
the class ids are compared with ``core.predict_c_grid``'s plain matmul
readout, which sums in another order. Then a hot swap: the fit continues on
fresh rows and serving keeps every queued request.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core import fit_chunked_many, ovr_signs, predict_c_grid
from repro_torch.kernels.ops import predict_bank
from repro_torch.serve import BankServer


def make_blobs(n, n_classes, d, seed, proto_seed=0):
    proto = (np.random.default_rng(proto_seed).normal(size=(n_classes, d)) * 3).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    X = (rng.normal(size=(n, d)) + proto[labels]).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X, labels


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--n-test", type=int, default=600)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--classes", type=int, default=200)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    n_classes, c_pts, d = args.classes, (1.0, 10.0, 100.0), args.d
    Xtr, ytr = make_blobs(args.n_train, n_classes, d, seed=0)
    Xte, yte = make_blobs(args.n_test, n_classes, d, seed=1)

    # --- train: one stream pass over chunks, bank checkpointed ------------
    signs = ovr_signs(ytr, n_classes, device=dev)  # (n_classes, N)
    Y = signs.repeat(len(c_pts), 1)  # class-major per C point
    cs = torch.tensor(c_pts, device=dev).repeat_interleave(n_classes)
    X = torch.as_tensor(Xtr, device=dev)
    chunk = max(1, args.n_train // 4)
    chunks = [(X[lo : lo + chunk], Y[:, lo : lo + chunk]) for lo in range(0, len(Xtr), chunk)]
    t0 = time.perf_counter()
    result = fit_chunked_many(chunks, cs, b_tile=64, stream_dtype="bf16")
    sync(dev)
    t_fit = time.perf_counter() - t0
    bank = result.ball
    print(f"fit: {bank.w.shape[0]} models, ONE {result.position}-row stream pass in "
          f"{t_fit * 1e3:.0f} ms on {dev}; bank state O(B*D) = "
          f"{bank.w.numel() * bank.w.element_size()} bytes")

    with tempfile.TemporaryDirectory() as td:
        ckpt.save(td, bank, meta={"position": result.position, "n_classes": n_classes})
        server = BankServer.from_checkpoint(td, epilogue="ovr", q_block=256,
                                            b_tile=min(200, bank.w.shape[0]), device=dev)
        print(f"serving bank {server.bank_shape} from checkpoint "
              f"(n_classes={server.n_classes} via checkpoint meta)")
        rng = np.random.default_rng(7)
        reqs, lo = [], 0
        while lo < len(Xte):  # ragged client batches, FIFO-packed into slots
            n = int(rng.integers(1, 200))
            reqs.append(server.submit(Xte[lo : lo + n]))
            lo += n
        t0 = time.perf_counter()
        stats = server.run()
        sync(dev)
        t_serve = time.perf_counter() - t0

    cls = np.concatenate([r.result[0] for r in reqs])
    margin = np.concatenate([r.result[1] for r in reqs])

    # --- served == the kernel's direct readout, bit for bit ---------------
    dcls, dmargin = predict_bank(torch.as_tensor(Xte, device=dev), bank.w, epilogue="ovr",
                                 n_classes=n_classes, q_block=256,
                                 b_tile=min(200, bank.w.shape[0]))
    assert np.array_equal(cls, dcls.cpu().numpy()), "served class ids diverged"
    assert np.array_equal(margin, dmargin.cpu().numpy()), "served margins diverged"
    rcls, _ = predict_c_grid(bank, torch.as_tensor(Xte, device=dev), n_classes)
    agree = float(np.mean(cls == rcls.cpu().numpy()))
    print(f"served {len(Xte)} queries x {bank.w.shape[0]} models in {stats.steps} microbatches "
          f"({t_serve * 1e3:.0f} ms, {len(Xte) / t_serve:.0f} queries/s, slot utilization "
          f"{stats.utilization:.1%}); served f32 results BIT-EXACT with ops.predict_bank; "
          f"class ids agree with core.predict_c_grid on {agree:.2%}")
    for g, cval in enumerate(c_pts):
        acc = float(np.mean(cls[:, g] == yte))
        print(f"  C={cval:6.1f}  served held-out acc={100 * acc:5.1f}%")

    # --- hot swap: re-fit continues, serving never drops a request --------
    half = min(500, len(Xte))
    more = [(torch.as_tensor(Xte[:half], device=dev),
             ovr_signs(yte[:half], n_classes, device=dev).repeat(len(c_pts), 1))]
    result2 = fit_chunked_many(more, cs, resume=result, b_tile=64, stream_dtype="bf16")
    for lo in range(0, min(256, len(Xte)), 64):
        server.submit(Xte[lo : lo + 64])
    server.step()  # the first 256 rows score against the OLD bank
    server.swap_bank(result2.ball)  # queued requests survive the swap
    server.run()
    print(f"hot-swapped to the {result2.position}-row bank mid-stream "
          f"({server.stats.bank_swaps} swap, {server.stats.finished} requests finished, "
          "none dropped)")
    return {"fit_s": t_fit, "serve_s": t_serve, "steps": stats.steps}


if __name__ == "__main__":
    main()
