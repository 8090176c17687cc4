"""One-pass kernelized bank: B core-set CVMs per stream read (paper Sec 4.2).

The bank engine's kernel-space twin with bounded memory: each model of a
B-model bank keeps a core-set buffer of at most ``coreset_size`` (S) stream
rows,

  idx:  (B, S) int32, the stream indices of the buffered rows (-1 free)
  coef: (B, S) f32, their signed Lagrange coefficients,

so the state is O(B S D) however long the stream, and the stream is read
once for all B models (classes x C-grid flatten onto the bank axis).

Per stream tile of ``block_n`` rows the engine runs the reference's
sequence (``repro/core/kernel_bank.py``):

  1. gather the core-set rows at tile entry from the whole stream (f32);
  2. K_cs = k(tile, core sets)  (block_n, B, S): kernel B5, one launch per
     ``s_tile`` chunk of the S axis (bit-exact with one launch);
  3. K_tt = k(tile, tile)  (block_n, block_n): kernel B5;
  4. for "farthest-point", the (B, S, S) buffer Gram (``meb._pair_gram``, a
     batched product and the RBF map, as the reference's einsum);
  5. the row recursion over the tile: kernel R1 (``kernels.kernel_bank``).

A row inserted mid-tile reads its kernel values against later rows from
K_tt, so the recursion is row-at-a-time exactly. Each model seeds on its
first row with a nonzero sign (the paper's line-3 init as a forced step
s = 1). With ``stream_dtype="bf16"`` the tile (B5's A operand) is rounded
while the core-set rows are gathered from the f32 stream, as the reference
does: K_cs is k(rounded tile, f32 points), K_tt k(rounded, rounded), and
k(x, x) is K_tt's diagonal.

Evictions when a buffer is full ("On Coresets for SVMs", PAPERS.md):
"smallest-coef" drops the smallest |coef|; "farthest-point" drops the slot
closest to the center. Free slots are filled first. With S >= N nothing is
evicted and the engine reproduces ``fit_kernelized`` per model.

Row norms of the stream are computed once per pass (``kernels.gram.
row_norms``, the Gram's own chain) and gathered, so a chunk of the K_cs
launch sees the norms of the whole launch and K(x, x) is 1 exactly for
"rbf". On the card the stream lives in device memory for the pass (the
tile-entry gather reads all of it).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import as_tensor, pick_device
from .meb import _pair_gram

_KERNELS = ("linear", "rbf")
_EVICTIONS = ("smallest-coef", "farthest-point")


class KernelBank(NamedTuple):
    """Streaming state / result of the kernelized bank engine.

    idx:    (B, S) int32, stream index of each buffered row, -1 free.
    coef:   (B, S) f32 signed coefficients (exactly 0 in free slots).
    points: (B, S, D) f32, the buffered rows themselves (zeros in free
            slots), gathered at the end of the fit so checkpoints serve
            without the stream.
    q:      (B,) running |center|^2 (the dense recursion).
    r:      (B,) radius.
    xi2:    (B,) slack-block squared norm.
    m:      (B,) int32 absorb count (0: the model saw no live row, an
            identity for the merge).
    """

    idx: torch.Tensor
    coef: torch.Tensor
    points: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    xi2: torch.Tensor
    m: torch.Tensor


def _kdiag(X, kernel: str):
    """k(x, x) per row, matching the Gram epilogue: |x|^2 for "linear"; the
    ones vector for "rbf" (exp(-gamma * 0), whatever x and gamma)."""
    x2 = torch.sum(X.float() ** 2, dim=-1)
    if kernel == "rbf":
        return torch.ones_like(x2)
    return x2


def _gather(Xf, idx):
    """(B, S, D) rows of the stream at ``idx``, zeros in free slots."""
    return torch.where((idx >= 0)[..., None], Xf[torch.clamp(idx, min=0)], 0.0)


def _finish(Xf, state) -> KernelBank:
    idx, coef, q, r, xi2, m = state
    return KernelBank(idx=idx, coef=coef, points=_gather(Xf, idx), q=q, r=r, xi2=xi2, m=m)


def _fit_kernel_bank(X, Y, cs, gamma, *, kernel, coreset_size, eviction, variant, block_n,
                     s_tile, stream_dtype, device=None, plain=False,
                     smem_budget=None) -> KernelBank:
    """Engine core of ``fit_kernel_bank`` (no validation of the seed signs).

    ``plain=True`` runs the plain versions of B5 and R1 on the same path
    whatever the device (the card's check of the kernels); otherwise their
    wrappers dispatch on the device, R1 in the layout ``rows_plan`` picks at
    ``smem_budget``.
    """
    from ..kernels.gram import gram_fused, gram_plain, row_norms, row_norms_plain
    from ..kernels.kernel_bank import kernel_bank_rows, kernel_bank_rows_plain
    from ..kernels.ops import _pad_to, _resolve_stream_dtype

    if plain:
        gram_fn, norms_fn, rows_fn = gram_plain, row_norms_plain, kernel_bank_rows_plain
    else:
        gram_fn, norms_fn, rows_fn = gram_fused, row_norms, kernel_bank_rows
    dev = pick_device(device, X, Y)
    Xf, Y = as_tensor(X, dev, torch.float32), as_tensor(Y, dev, torch.float32)
    n, d = Xf.shape
    b, n_y = Y.shape
    if n_y != n:
        raise ValueError(
            f"Y must be (B, N) sign rows matching X: got Y.shape={tuple(Y.shape)}, "
            f"X.shape={tuple(Xf.shape)}"
        )
    s_size = int(coreset_size)
    sdt = _resolve_stream_dtype(stream_dtype)
    cs = as_tensor(cs, dev, torch.float32).broadcast_to((b,))
    gamma = float(gamma)
    c_inv = (1.0 / cs).contiguous()
    gain = c_inv if variant == "exact" else torch.ones_like(c_inv)
    st = s_size if s_tile is None else min(int(s_tile), s_size)
    farthest = eviction == "farthest-point"

    idx = torch.full((b, s_size), -1, dtype=torch.int32, device=dev)
    coef = torch.zeros((b, s_size), dtype=torch.float32, device=dev)
    q, r, xi2 = (torch.zeros((b,), dtype=torch.float32, device=dev) for _ in range(3))
    m = torch.zeros((b,), dtype=torch.int32, device=dev)

    n_tiles = -(-n // block_n)
    Xs = Xf.to(sdt)  # the streamed tiles, rounded when bf16
    norms_f = norms_fn(Xf)  # core-set rows come from the f32 stream
    norms_s = norms_f if sdt == torch.float32 else norms_fn(Xs)
    Yp = _pad_to(Y, block_n, 1)
    for t in range(n_tiles):
        lo, hi = t * block_n, min((t + 1) * block_n, n)
        x_stream = _pad_to(Xs[lo:hi], block_n, 0)
        an = _pad_to(norms_s[lo:hi], block_n, 0)
        y_tile = Yp[:, t * block_n : (t + 1) * block_n].contiguous()
        live = idx >= 0
        xc = _gather(Xf, idx)  # (B, S, D)
        xcn = torch.where(live, norms_f[torch.clamp(idx, min=0)], 0.0)
        parts = []
        for s0 in range(0, s_size, st):
            s1 = min(s0 + st, s_size)
            k = gram_fn(x_stream, xc[:, s0:s1].reshape(b * (s1 - s0), d), an,
                        xcn[:, s0:s1].reshape(-1), gamma, epilogue=kernel)
            parts.append(k.reshape(block_n, b, s1 - s0))
        k_cs = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
        k_tt = gram_fn(x_stream, x_stream.float(), an, an, gamma, epilogue=kernel)
        kbb = _pair_gram(xc, xc, kernel, gamma).contiguous() if farthest else None
        rows_fn(k_cs.contiguous(), k_tt, y_tile, idx, coef, q, r, xi2, m, c_inv, gain,
                base=lo, n_valid=hi - lo, kbb=kbb, smem_budget=smem_budget)
    return _finish(Xf, (idx, coef, q, r, xi2, m))


def fit_kernel_bank(
    X,
    Y,
    cs,
    *,
    kernel: str = "rbf",
    gamma=1.0,
    coreset_size: int = 64,
    eviction: str = "smallest-coef",
    variant: str = "exact",
    block_n: int = 256,
    s_tile: int | None = None,
    stream_dtype=None,
    mesh=None,
    shard_axis="data",
    vmem_budget_bytes: int | None = None,
    seed_check: bool = True,
    device=None,
) -> KernelBank:
    """One-pass kernelized Algorithm 1 for a bank of B models, through
    kernels B5 (the Gram blocks) and R1 (the row recursion).

    X: (N, D) shared stream; Y: (B, N) per-model label signs in {-1, 0, +1}
    (0: the row is inert for that model). ``Y[:, 0]`` must be +-1 unless
    ``seed_check=False`` (a continuation chunk, whose first rows may be inert
    for some models: each model then seeds on its first live row). cs:
    scalar or (B,) per-model C; gamma: the RBF bandwidth.

    kernel: "rbf" (exp(-gamma d^2), d^2 clamped at 0) or "linear".
    coreset_size: S, the per-model buffer bound. eviction: "smallest-coef"
    or "farthest-point". variant: "exact" / "paper-listing" (the slack
    gain). block_n: stream rows per tile. s_tile: chunk the K_cs launch over
    the S axis (bit-exact with one launch). stream_dtype: "bf16" rounds the
    streamed tiles; the buffered rows and the state stay f32.

    vmem_budget_bytes: the preflight's budget (else ``ops.vmem_budget_bytes()``):
    every call holds ``ops.kernel_engine_vmem_bytes``, the shared memory per
    CTA of B5's launches and of R1's, each on its own (they are separate
    launches), to it and raises with the breakdown before any launch. R1
    takes the layout ``rows_plan`` picks under the same budget, which is
    never more than the budget, so only B5's tiles can refuse. What
    ``s_tile`` caps (the K_cs block, the gathered core-set operand) lives
    in device memory, which that budget does not see.

    ``mesh=`` (a ``torch.distributed`` DeviceMesh) shards the stream over
    its ``shard_axis`` axes: per-range fits folded with the kernelized
    Sec-4.3 merge (``distributed.fit_kernel_bank_sharded``).
    """
    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {_KERNELS}")
    if eviction not in _EVICTIONS:
        raise ValueError(f"unknown eviction {eviction!r}; expected one of {_EVICTIONS}")
    if variant not in ("exact", "paper-listing"):
        raise ValueError(
            f"unknown variant {variant!r}; expected 'exact' or 'paper-listing'"
        )
    if int(coreset_size) < 1:
        raise ValueError(f"coreset_size must be >= 1, got {coreset_size}")
    if s_tile is not None and int(s_tile) < 1:
        raise ValueError(f"s_tile must be >= 1 (or None), got {s_tile}")
    if Y.ndim != 2:
        raise ValueError(f"Y must be (B, N) sign rows: got Y.shape={tuple(Y.shape)}")
    if seed_check:
        y0 = Y[:, 0].detach().cpu().numpy() if isinstance(Y, torch.Tensor) else np.asarray(Y)[:, 0]
        bad = np.flatnonzero(y0 == 0)
        if bad.size:
            raise ValueError(
                "fit_kernel_bank needs Y[:, 0] in {-1, +1}: row 0 seeds "
                "every model, and a sign-0 seed almost always means the "
                "label encoding dropped a model. Offending model rows "
                f"(Y[b, 0] == 0): b = {bad.tolist()}"
            )
    from ..kernels.ops import kernel_engine_vmem_bytes, vmem_budget_bytes as _vmem_budget

    b, d = Y.shape[0], X.shape[-1]
    budget = _vmem_budget(vmem_budget_bytes)
    by = kernel_engine_vmem_bytes(
        b, d, coreset_size=coreset_size, block_n=block_n, s_tile=s_tile,
        stream_dtype=stream_dtype, eviction=eviction, smem_budget=budget,
    )
    if max(by.values()) > budget:
        raise ValueError(
            f"fit_kernel_bank with B={b}, D={d}, S={coreset_size}, "
            f"block_n={block_n}, s_tile={s_tile} needs {max(by.values())} bytes "
            f"of shared memory per CTA in one launch (breakdown: {by}; B5 and R1 "
            f"launch separately), exceeding the budget of {budget} bytes — raise "
            "the budget: the card's Gram tiles do not shrink with s_tile or "
            "block_n. The budget follows vmem_budget_bytes(): pass "
            "vmem_budget_bytes= or set REPRO_VMEM_BUDGET_BYTES."
        )
    if mesh is not None:
        from .distributed import fit_kernel_bank_sharded  # lazy: module cycle

        return fit_kernel_bank_sharded(
            X, Y, cs, mesh, axis=shard_axis, kernel=kernel, gamma=gamma,
            coreset_size=coreset_size, eviction=eviction, variant=variant, block_n=block_n,
            s_tile=s_tile, stream_dtype=stream_dtype, device=device,
        )
    return _fit_kernel_bank(
        X, Y, cs, gamma, kernel=kernel, coreset_size=coreset_size, eviction=eviction,
        variant=variant, block_n=block_n, s_tile=s_tile, stream_dtype=stream_dtype,
        device=device, smem_budget=budget,
    )


def kernel_bank_decision(bank: KernelBank, X, *, kernel: str = "rbf", gamma=1.0,
                         device=None):
    """(Q, B) decision margins of every model against the stored core sets,
    through ``ops.predict_kernel_bank`` ("scores"): the path ``BankServer``
    serves, so served scores equal this readout bit for bit."""
    from ..kernels.ops import predict_kernel_bank

    return predict_kernel_bank(X, bank.points, bank.coef, kernel=kernel, gamma=gamma,
                               device=device)


def save_kernel_bank(path: str, bank: KernelBank, *, kernel: str, gamma: float = 1.0,
                     meta: dict | None = None) -> None:
    """Checkpoint a KernelBank so ``BankServer.from_checkpoint`` can serve it:
    the 7 leaves through ``ckpt.save``, with ``meta["bank_kind"] = "kernel"``
    and the kernel and gamma the fit used."""
    from ..checkpoint import ckpt

    if kernel not in _KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {_KERNELS}")
    full_meta = dict(meta or {})
    full_meta.update({"bank_kind": "kernel", "kernel": kernel, "gamma": float(gamma)})
    ckpt.save(path, bank, meta=full_meta)
