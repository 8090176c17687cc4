"""R1: the kernelized bank's core-set row recursion over one stream tile.

The port of ``row_body`` in ``repro/core/kernel_bank.py`` (a ``lax.scan``
over a tile's rows there, no Pallas kernel). The kernel is CUDA C++ for
Hopper, in ``csrc/kernel_bank.cu``; its header says how it is laid out and
what bounds it.

``kernel_bank_rows`` dispatches on the device of ``k_cs``: a CPU tensor runs
``kernel_bank_rows_plain``, a CUDA tensor launches the kernel, or raises.
Both advance the state tensors in place from the tile's Gram blocks:

  k_cs  (block_n, B, S)  k(tile row i, core-set slot (b, s)) at tile entry
  k_tt  (block_n, block_n)  k(tile row, tile row); its diagonal is k(x, x)
  y     (B, block_n)  the tile's signs (0: inert for that model)
  idx (B, S) int32, coef (B, S), q, r, xi2 (B,), m (B,) int32: the state
  kbb   (B, S, S) the buffer Gram at tile entry, for "farthest-point" only
        (None selects "smallest-coef"); updated in place too.

Rows at or past ``n_valid`` are inert; ``base`` is the stream index of the
tile's row 0. Sums over slots are ``gram.tree_sum`` trees in both versions,
and each operation is rounded on its own, so on the same K blocks every
layout of the kernel and the plain version agree bit for bit.

``rows_plan`` picks the launch's layout by bytes, before the launch: the
"staged" layout (the stream side copied into shared memory a 32-row block
ahead, a block of rows evaluated at once against one state, one ballot per
update) where S pads to at most 256 slots and its shared memory fits the
budget, 2 models per CTA; else the first port's layouts, which
take no shared memory: "registers" (S padded to at most 256) or "wide" (the
slots in a device-memory scratch the wrapper allocates). So any S >= 1 runs
under any budget.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .gram import tree_sum
from .streamsvm_scan import SMEM_PER_BLOCK

_P, _I = ctypes.c_void_p, ctypes.c_int

#: Rows of a staged block (``BLK`` in csrc/kernel_bank.cu), blocks in
#: flight (``NBUF``), the largest padded S the staged kernel unrolls
#: (``STAGED_MAX_SP``) and its models per CTA (``MPC``).
STAGED_BLOCK, STAGED_BUFFERS, STAGED_MAX_SP, STAGED_MPC = 32, 2, 256, 2


def _lib() -> ctypes.CDLL:
    lib = _build.load("kernel_bank")
    lib.kernel_bank_rows.argtypes = [_P] * 12 + [_I] * 5 + [_P, _P]
    lib.kernel_bank_rows.restype = ctypes.c_int
    lib.kernel_bank_rows_scratch_bytes.argtypes = [_I, _I]
    lib.kernel_bank_rows_scratch_bytes.restype = ctypes.c_long
    lib.kernel_bank_rows_staged.argtypes = [_P] * 12 + [_I] * 5 + [_P]
    lib.kernel_bank_rows_staged.restype = ctypes.c_int
    lib.kernel_bank_rows_staged_bytes.argtypes = [_I, _I]
    lib.kernel_bank_rows_staged_bytes.restype = ctypes.c_long
    return lib


def _padded(s: int) -> int:
    return 1 << max(int(s) - 1, 0).bit_length()


def staged_smem(s: int, *, farthest: bool = False) -> dict:
    """Dynamic shared memory of the staged layout (its only shared memory),
    bytes by term, as ``kernel_bank_rows_staged_bytes`` in csrc computes it:
    two blocks of 32 rows, each row the CTA's 2 models' S values padded to
    whole 16-byte units and pitched to an odd number of them; per model the
    coefs, idx, in-tile rows and in-tile list (S padded to 4 words each);
    for "farthest-point" each model's S x S Kbb slab at the same pitch rule;
    and 32 bytes of barriers and counters."""
    quad = lambda w: (w + 3) // 4 * 4
    odd = lambda w: w if (w // 4) % 2 else w + 4
    s4 = quad(int(s))
    rp, kp = odd(STAGED_MPC * s4), odd(s4)
    return {
        "staged_blocks": 4 * STAGED_BUFFERS * STAGED_BLOCK * rp,
        "slot_state": 4 * 4 * STAGED_MPC * s4,
        "buffer_gram": 4 * STAGED_MPC * int(s) * kp if farthest else 0,
        "barriers": 32,
    }


@functools.lru_cache(maxsize=256)
def rows_plan(b: int, s: int, *, farthest: bool = False, smem_budget: int | None = None) -> dict:
    """R1's launch layout for B models of S slots, by bytes alone (a shared
    dict: do not change it).

    "staged" where S pads to at most ``STAGED_MAX_SP`` slots and its shared
    memory (``staged_smem``) fits ``smem_budget`` (capped at the card's
    SMEM_PER_BLOCK); otherwise "registers" (S padded to at most 256) or
    "wide" (the slots in a device scratch), which take no shared memory, so
    every S runs under every budget. Returns ``layout``, ``models_per_cta``,
    ``ctas`` and ``smem`` by term. Every layout gives the same bits."""
    limit = SMEM_PER_BLOCK if smem_budget is None else min(int(smem_budget), SMEM_PER_BLOCK)
    if _padded(s) <= STAGED_MAX_SP:
        smem = staged_smem(s, farthest=farthest)
        if sum(smem.values()) <= limit:
            return dict(layout="staged", models_per_cta=STAGED_MPC,
                        ctas=-(-int(b) // STAGED_MPC), smem=smem)
    return dict(layout="registers" if _padded(s) <= STAGED_MAX_SP else "wide",
                models_per_cta=4, ctas=-(-int(b) // 4), smem={})


def rows_layouts(b: int, s: int, *, farthest: bool = False) -> list[dict]:
    """Every layout ``rows_plan`` picks for B models of S slots as the budget
    falls from the card's limit to 0: "staged" where it fits the card, then
    the first port's. A budget of a plan's own bytes
    (``sum(plan["smem"].values())``) launches it: tests and chip_smoke.py
    force each layout so."""
    out = [rows_plan(b, s, farthest=farthest)]
    if out[0]["layout"] == "staged":
        out.append(rows_plan(b, s, farthest=farthest, smem_budget=0))
    return out


def _check_args(k_cs, k_tt, y, idx, coef, q, r, xi2, m, c_inv, gain, kbb):
    bn, b, s = k_cs.shape
    if k_tt.shape != (bn, bn) or y.shape != (b, bn):
        raise ValueError(
            f"k_tt must be (block_n, block_n) and y (B, block_n) for k_cs of shape "
            f"(block_n, B, S)={tuple(k_cs.shape)}: got k_tt.shape={tuple(k_tt.shape)}, "
            f"y.shape={tuple(y.shape)}"
        )
    for name, v, shape in (("idx", idx, (b, s)), ("coef", coef, (b, s)), ("q", q, (b,)),
                           ("r", r, (b,)), ("xi2", xi2, (b,)), ("m", m, (b,)),
                           ("c_inv", c_inv, (b,)), ("gain", gain, (b,))):
        if v.shape != shape:
            raise ValueError(f"{name} must be {shape}: got {tuple(v.shape)}")
    if kbb is not None and kbb.shape != (b, s, s):
        raise ValueError(f"kbb must be (B, S, S)={(b, s, s)}: got {tuple(kbb.shape)}")


def kernel_bank_rows_plain(k_cs, k_tt, y, idx, coef, q, r, xi2, m, c_inv, gain, *,
                           base: int, n_valid: int, kbb=None, smem_budget=None) -> None:
    """Plain PyTorch version of R1: ``row_body`` row by row, every model at
    once, with the reference's wheres, clamp and first-minimum argmins.
    ``smem_budget`` is the kernel's and changes nothing here."""
    _check_args(k_cs, k_tt, y, idx, coef, q, r, xi2, m, c_inv, gain, kbb)
    bn, b, s_size = k_cs.shape
    farthest = kbb is not None
    ix, cf, qq, rr, xx, mm = (t.clone() for t in (idx, coef, q, r, xi2, m))
    kb = kbb.clone() if farthest else None
    intile = torch.full_like(ix, -1)
    kdiag = torch.diagonal(k_tt)
    slots = torch.arange(s_size, device=k_cs.device)
    for i in range(bn):
        kv = torch.where(intile >= 0, k_tt[torch.clamp(intile, min=0), i], k_cs[i])
        g = tree_sum(cf * kv)
        yn = y[:, i]
        ok = (yn != 0) & (i < n_valid)
        seed = (mm == 0) & ok
        d2 = qq - 2.0 * yn * g + kdiag[i] + xx + c_inv
        dist = torch.sqrt(torch.clamp(d2, min=1e-12))
        upd = ~seed & ok & (dist >= rr)
        act = seed | upd
        s = torch.where(seed, 1.0, torch.where(upd, 0.5 * (1.0 - rr / dist), 0.0))
        if farthest:
            gs = tree_sum(kb * cf[:, None, :])
            score = torch.where(
                ix >= 0,
                qq[:, None] - 2.0 * torch.sign(cf) * gs + torch.diagonal(kb, dim1=1, dim2=2),
                -torch.inf,
            )  # squared center->point distance; evict the closest
            slot = torch.argmin(score, dim=1)
        else:
            slot = torch.argmin(torch.abs(cf), dim=1)
        hit = (slots[None, :] == slot[:, None]) & act[:, None]
        if farthest:
            kb = torch.where(hit[:, :, None], kv[:, None, :], kb)
            kb = torch.where(hit[:, None, :], kv[:, :, None], kb)
            kb = torch.where(hit[:, :, None] & hit[:, None, :], kdiag[i], kb)
        om = 1.0 - s
        cf = cf * om[:, None]
        cf = torch.where(hit, (s * yn)[:, None], cf)
        ix = torch.where(hit, base + i, ix)
        intile = torch.where(hit, i, intile)
        qq = om * om * qq + 2.0 * s * om * yn * g + s * s * kdiag[i]
        rr = rr + torch.where(upd, 0.5 * (dist - rr), 0.0)
        xx = xx * (om * om) + s * s * gain
        mm = mm + act.to(torch.int32)
    for dst, src in zip((idx, coef, q, r, xi2, m), (ix, cf, qq, rr, xx, mm)):
        dst.copy_(src)
    if farthest:
        kbb.copy_(kb)


def kernel_bank_rows(k_cs, k_tt, y, idx, coef, q, r, xi2, m, c_inv, gain, *,
                     base: int, n_valid: int, kbb=None, smem_budget=None) -> None:
    """R1 on the device of ``k_cs``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Arguments as in the module docstring;
    the state (and ``kbb``) is advanced in place. The kernel launches the
    layout ``rows_plan`` picks under ``smem_budget``."""
    if k_cs.device.type == "cpu":
        return kernel_bank_rows_plain(k_cs, k_tt, y, idx, coef, q, r, xi2, m, c_inv, gain,
                                      base=base, n_valid=n_valid, kbb=kbb)
    if k_cs.device.type != "cuda":
        raise ValueError(f"kernel_bank_rows runs on cuda or cpu, not {k_cs.device}")
    _check_args(k_cs, k_tt, y, idx, coef, q, r, xi2, m, c_inv, gain, kbb)
    bn, b, s_size = k_cs.shape
    lib = _lib()
    floats = (k_cs, k_tt, y, c_inv, gain, coef, q, r, xi2) + ((kbb,) if kbb is not None else ())
    for t in floats:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != k_cs.device:
            raise ValueError("R1 takes contiguous float32 tensors on one device")
    for t in (idx, m):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != k_cs.device:
            raise ValueError("R1 takes contiguous int32 idx and m on the device of k_cs")
    dev = k_cs.device
    plan = rows_plan(b, s_size, farthest=kbb is not None, smem_budget=smem_budget)
    ptrs = (k_cs.data_ptr(), k_tt.data_ptr(), y.data_ptr(), c_inv.data_ptr(), gain.data_ptr(),
            idx.data_ptr(), coef.data_ptr(), q.data_ptr(), r.data_ptr(), xi2.data_ptr(),
            m.data_ptr(), kbb.data_ptr() if kbb is not None else None)
    ints = (b, s_size, bn, int(min(n_valid, bn)), int(base))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan["layout"] == "staged":
        err = lib.kernel_bank_rows_staged(*ptrs, *ints, stream)
    else:  # the first port's layouts: registers, or the slots in a scratch
        nbytes = lib.kernel_bank_rows_scratch_bytes(b, s_size)
        scratch = torch.empty(nbytes, device=dev, dtype=torch.uint8) if nbytes else None
        err = lib.kernel_bank_rows(*ptrs, *ints, None if scratch is None else scratch.data_ptr(),
                                   stream)
    _build.check(err, f"kernel_bank_rows ({plan['layout']})")
    kernel_bank_rows.launches += 1


kernel_bank_rows.launches = 0  # kernel launches, read by chip_smoke.py
