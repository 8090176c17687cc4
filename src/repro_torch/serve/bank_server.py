"""Bank serving: microbatched query scoring against a trained (B, D) bank.

A fixed microbatch of ``q_block`` row slots (kernel B2's query tile), so
every step is one launch. Ragged requests are packed FIFO into the free
slots of each step: a large request spans several steps and several small
ones share a step, so slots go idle only in the final partial batch.
``ServerStats`` counts busy and idle row slots.

Train -> serve: ``BankServer.from_checkpoint`` loads the stacked-Ball bank
a ``fit_chunked_many`` checkpoint callback saved with ``ckpt.save``, or the
7-leaf KernelBank ``save_kernel_bank`` saved (``meta["bank_kind"] ==
"kernel"``, with the kernel and gamma in the meta), taking ``n_classes``
from the meta when serving OVR.

Kernel mode: a ``KernelBank`` (its (B, S, D) core-set ``points`` and (B, S)
``coef``) is scored through ``kernels.ops.predict_kernel_bank`` (kernel
B5) with the ``kernel=`` and ``gamma=`` it was trained with.

Hot swap: ``swap_bank`` replaces the bank between steps without dropping
queued requests; rows already scored keep their results, every row scored
after the swap sees the new bank.

Live-loop checkpoints wait for their slice (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import as_tensor, pick_device
from ..core.kernel_bank import KernelBank
from ..core.meb import Ball, _is_kernel_bank
from ..kernels.gram import row_norms
from ..kernels.ops import _check_resident, predict_bank, predict_kernel_bank


@dataclasses.dataclass
class ScoreRequest:
    """One scoring request: a ragged block of query rows and its results.

    ``result`` is filled in place as microbatches cover the request's rows:
    an (n, B) f32 array for "scores", ``((n, G) int32 class ids, (n, G) f32
    margins)`` for "ovr", ``((n, k) f32, (n, k) int32)`` for "topk".
    """

    rid: int
    queries: np.ndarray  # (n, D) float32
    result: Union[np.ndarray, Tuple[np.ndarray, ...], None] = None
    rows_scored: int = 0
    done: bool = False


@dataclasses.dataclass
class ServerStats:
    """Row-slot accounting."""

    steps: int = 0
    admitted: int = 0
    finished: int = 0
    slot_busy_rows: int = 0
    slot_idle_rows: int = 0
    bank_swaps: int = 0

    @property
    def utilization(self) -> float:
        tot = self.slot_busy_rows + self.slot_idle_rows
        return self.slot_busy_rows / tot if tot else 0.0


class BankServer:
    """Serve a trained bank: microbatch, score, hot-swap.

    bank: a stacked ``Ball`` or a (B, D) weight array, scored through B2;
    or a ``KernelBank``, scored through ``predict_kernel_bank`` (B5), which
    needs ``kernel=`` ("linear"/"rbf") and ``gamma=`` as the bank was
    trained (``from_checkpoint`` takes them from the meta). epilogue /
    n_classes / k / q_block / b_tile / stream_dtype / bank_resident: the
    serving configuration, see ``kernels.ops.predict_bank``
    (``bank_resident="hbm"`` scores through B6, the ring, with the same
    bits; a kernel bank ignores ``b_tile`` and ``bank_resident``). ``device``: where the bank lives and
    the queries are scored (None: where a tensor bank lives, else CUDA).
    """

    def __init__(
        self,
        bank,
        *,
        epilogue: str = "scores",
        n_classes: Optional[int] = None,
        k: Optional[int] = None,
        q_block: int = 256,
        b_tile: Optional[int] = None,
        stream_dtype=None,
        bank_resident: str = "auto",
        kernel: Optional[str] = None,
        gamma: float = 1.0,
        device=None,
    ):
        _check_resident(bank_resident)
        if _is_kernel_bank(bank):
            if kernel is None:
                raise ValueError(
                    "serving a KernelBank needs kernel='linear' or 'rbf' "
                    "(the kernel the bank was trained with); pass it "
                    "explicitly or use from_checkpoint, which restores it "
                    "from the checkpoint meta"
                )
            self.device = pick_device(device, bank.points)
            self._w = None
            self._points, self._coef, self._point_norms = self._kernel_bank_arrays(bank)
            b, _, d = self._points.shape
        else:
            if kernel is not None:
                raise ValueError(
                    f"kernel={kernel!r} only applies to a KernelBank; this "
                    "bank is a linear (B, D) weight bank"
                )
            w = bank.w if hasattr(bank, "w") else bank
            self.device = pick_device(device, w)
            self._w = self._bank_weights(bank)
            self._points = self._coef = self._point_norms = None
            b, d = self._w.shape
        self.kernel = kernel
        self.gamma = float(gamma)
        self._b, self._d = b, d
        if epilogue not in ("scores", "ovr", "topk"):
            raise ValueError(
                f"unknown epilogue {epilogue!r}; expected 'scores', 'ovr' or 'topk'"
            )
        if epilogue == "ovr":
            if n_classes is None or n_classes < 1 or b % n_classes:
                raise ValueError(
                    f"epilogue='ovr' needs n_classes >= 1 dividing B: got "
                    f"n_classes={n_classes}, B={b}"
                )
        elif epilogue == "topk" and (k is None or not (1 <= k <= b)):
            raise ValueError(f"epilogue='topk' needs 1 <= k <= B: got k={k}, B={b}")
        self.epilogue = epilogue
        self.n_classes = n_classes
        self.k = k
        self.q_block = int(q_block)
        self.b_tile = b_tile
        self.stream_dtype = stream_dtype
        self.bank_resident = bank_resident
        self.stats = ServerStats()
        self._queue: List[ScoreRequest] = []  # FIFO; head may be partial
        self._next_rid = 0

    # -- bank management ----------------------------------------------------

    def _kernel_bank_arrays(self, bank) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(points, coef, point norms) of a KernelBank on the server's device;
        the norms are computed here, once per bank, not on every step."""
        points = as_tensor(bank.points, self.device, torch.float32)
        coef = as_tensor(bank.coef, self.device, torch.float32)
        if points.ndim != 3 or tuple(coef.shape) != tuple(points.shape[:2]):
            raise ValueError(
                f"KernelBank needs (B, S, D) points with (B, S) coef: got "
                f"points.shape={tuple(points.shape)}, coef.shape={tuple(coef.shape)}"
            )
        return points, coef, row_norms(points.reshape(-1, points.shape[2]))

    def _bank_weights(self, bank) -> torch.Tensor:
        w = bank.w if hasattr(bank, "w") else bank
        w = as_tensor(w, self.device, torch.float32)
        if w.ndim != 2:
            raise ValueError(
                f"bank must be a stacked Ball or a (B, D) weight array: got "
                f"weights of shape {tuple(w.shape)}"
            )
        return w

    @property
    def bank_shape(self) -> Tuple[int, ...]:
        if self._w is None:
            return tuple(self._points.shape)
        return tuple(self._w.shape)

    def swap_bank(self, bank, *, kernel: Optional[str] = None, gamma=None) -> None:
        """Replace the served bank between steps; queued requests survive.

        The new bank must have the served shape: (B, D) weights for a linear
        server, (B, S, D) core sets for a kernel server (a linear bank cannot
        swap into a kernel server or the other way round). ``kernel`` /
        ``gamma``: optionally declare the config the incoming bank was trained
        with; a mismatch with the server's raises.
        """
        if kernel is not None and kernel != self.kernel:
            raise ValueError(
                f"hot-swap bank was trained with kernel={kernel!r}; this "
                f"server is configured kernel={self.kernel!r} "
                f"(gamma={self.gamma}) — scoring under a different kernel "
                "serves silent garbage; start a BankServer matching the "
                "bank's kernel config"
            )
        if gamma is not None and self.kernel is not None and float(gamma) != self.gamma:
            raise ValueError(
                f"hot-swap bank was trained with gamma={float(gamma)}; this "
                f"server is configured kernel={self.kernel!r} with "
                f"gamma={self.gamma} — scoring under a different gamma "
                "serves silent garbage; start a BankServer matching the "
                "bank's kernel config"
            )
        if self._w is None:
            if not _is_kernel_bank(bank):
                raise ValueError(
                    "this server serves a KernelBank; hot-swap needs another "
                    "KernelBank of the same (B, S, D) shape"
                )
            points, coef, norms = self._kernel_bank_arrays(bank)
            if points.shape != self._points.shape:
                raise ValueError(
                    f"hot-swap core-set shape {tuple(points.shape)} != "
                    f"served shape {tuple(self._points.shape)}; start a new "
                    "BankServer to change shape"
                )
            self._points, self._coef, self._point_norms = points, coef, norms
            self.stats.bank_swaps += 1
            return
        if _is_kernel_bank(bank):
            raise ValueError(
                "this server serves a linear (B, D) bank; a KernelBank "
                "needs its own BankServer(kernel=...)"
            )
        w = self._bank_weights(bank)
        if w.shape != self._w.shape:
            raise ValueError(
                f"hot-swap bank shape {tuple(w.shape)} != served bank shape "
                f"{tuple(self._w.shape)}; start a new BankServer to change shape"
            )
        self._w = w
        self.stats.bank_swaps += 1

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "BankServer":
        """Serve the bank a trainer checkpoint saved at ``path``: the stacked
        Ball (a ``ckpt.save`` directory with the 4 leaves w, r, xi2, m), or,
        when ``meta["bank_kind"] == "kernel"``, the 7-leaf KernelBank of
        ``save_kernel_bank``, with ``kernel``/``gamma`` from the meta unless
        given. ``meta["n_classes"]`` fills in OVR serving unless given."""
        from ..checkpoint import ckpt

        manifest = ckpt.load_manifest(path)
        shapes = manifest["shapes"]
        meta = manifest.get("meta", {})
        if "live_k" in meta:
            raise NotImplementedError(
                f"checkpoint at {path!r} is a live-loop checkpoint (meta live_k): "
                "serving it is not ported yet: ROADMAP A11"
            )
        dev = pick_device(kwargs.get("device"))
        if meta.get("bank_kind") == "kernel":
            if len(shapes) != len(KernelBank._fields):
                raise ValueError(
                    f"kernel-bank checkpoint at {path!r} has {len(shapes)} "
                    f"leaves; expected the {len(KernelBank._fields)}-leaf "
                    "KernelBank a save_kernel_bank checkpoint carries"
                )
            target = KernelBank(*ckpt.zeros_like_manifest(manifest, device=dev))
            kwargs.setdefault("kernel", meta.get("kernel"))
            kwargs.setdefault("gamma", float(meta.get("gamma", 1.0)))
        elif len(shapes) != 4:
            raise ValueError(
                f"checkpoint at {path!r} has {len(shapes)} leaves; expected "
                "the 4-leaf stacked Ball (w, r, xi2, m) a fit_chunked_many "
                "checkpoint carries"
            )
        else:
            target = Ball(*ckpt.zeros_like_manifest(manifest, device=dev))
        bank = ckpt.restore(path, target)
        if (
            kwargs.get("epilogue") == "ovr"
            and "n_classes" not in kwargs
            and "n_classes" in meta
        ):
            kwargs["n_classes"] = int(meta["n_classes"])
        return cls(bank, **kwargs)

    # -- request lifecycle --------------------------------------------------

    def submit(self, queries) -> ScoreRequest:
        """Queue a ragged block of query rows; returns its ScoreRequest."""
        if isinstance(queries, torch.Tensor):
            queries = queries.detach().cpu().numpy()
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self._d:
            raise ValueError(
                f"queries must be (n, D={self._d}) rows: got shape {q.shape}"
            )
        n = q.shape[0]
        b = self._b
        if self.epilogue == "scores":
            result = np.empty((n, b), np.float32)
        elif self.epilogue == "ovr":
            g = b // self.n_classes
            result = (np.empty((n, g), np.int32), np.empty((n, g), np.float32))
        else:
            result = (np.empty((n, self.k), np.float32), np.empty((n, self.k), np.int32))
        req = ScoreRequest(rid=self._next_rid, queries=q, result=result)
        self._next_rid += 1
        self.stats.admitted += 1
        if n == 0:  # nothing to score: finished on arrival
            req.done = True
            self.stats.finished += 1
        else:
            self._queue.append(req)
        return req

    def pending_rows(self) -> int:
        return sum(r.queries.shape[0] - r.rows_scored for r in self._queue)

    def step(self) -> int:
        """Pack up to q_block queued rows, score them in one launch (B2, or
        B5 for a kernel bank), scatter the results back. Returns the number
        of rows scored."""
        if not self._queue:
            return 0
        buf = np.zeros((self.q_block, self._d), np.float32)
        segments: List[Tuple[ScoreRequest, int, int, int]] = []
        filled = 0
        qi = 0
        while qi < len(self._queue) and filled < self.q_block:
            req = self._queue[qi]
            off = req.rows_scored
            take = min(req.queries.shape[0] - off, self.q_block - filled)
            buf[filled : filled + take] = req.queries[off : off + take]
            segments.append((req, off, take, filled))
            filled += take
            qi += 1
        queries = torch.from_numpy(buf).to(self.device)
        if self._w is None:
            out = predict_kernel_bank(
                queries, self._points, self._coef, kernel=self.kernel, gamma=self.gamma,
                epilogue=self.epilogue, n_classes=self.n_classes, k=self.k,
                q_block=self.q_block, stream_dtype=self.stream_dtype,
                point_norms=self._point_norms,
            )
        else:
            out = predict_bank(
                queries,
                self._w,
                epilogue=self.epilogue,
                n_classes=self.n_classes,
                k=self.k,
                q_block=self.q_block,
                b_tile=self.b_tile,
                stream_dtype=self.stream_dtype,
                bank_resident=self.bank_resident,
            )
        parts = (out,) if self.epilogue == "scores" else out
        parts = tuple(p.cpu().numpy() for p in parts)
        finished = 0
        for req, off, take, at in segments:
            dests = (req.result,) if self.epilogue == "scores" else req.result
            for dst, src in zip(dests, parts):
                dst[off : off + take] = src[at : at + take]
            req.rows_scored = off + take
            if req.rows_scored == req.queries.shape[0]:
                req.done = True
                finished += 1
        self._queue = [r for r in self._queue if not r.done]
        self.stats.steps += 1
        self.stats.slot_busy_rows += filled
        self.stats.slot_idle_rows += self.q_block - filled
        self.stats.finished += finished
        return filled

    def run(self, max_steps: int = 100_000) -> ServerStats:
        """Drain the queue; raises if ``max_steps`` cannot cover it."""
        for _ in range(max_steps):
            if not self._queue:
                return self.stats
            self.step()
        if self._queue:
            raise RuntimeError(
                f"run(max_steps={max_steps}) left {self.pending_rows()} rows "
                f"pending in {len(self._queue)} request(s); raise max_steps"
            )
        return self.stats

    def score(self, queries):
        """Submit one request and drain: returns its epilogue result."""
        req = self.submit(queries)
        self.run()
        return req.result
