"""Continuous-batching TOKEN scheduler (slot-based LLM decode management).

One of serve/'s two schedulers: this module batches LLM decode steps;
``bank_server.py`` microbatches query scoring against a trained StreamSVM
bank (same slot/stats discipline, applied to rows instead of tokens).

The port of the reference's ``serve/token_scheduler.py``. A fixed pool of B
slots; requests join as slots free (admission = single-request prefill
whose state is written into the slot), every decode step advances all busy
slots together, finished requests release their slot immediately: no
head-of-line blocking on the longest request in the batch.

Scope: exact for the *recurrent* families (xlstm), whose per-slot state is
position-free: a fresh request's state drops into any slot at any time.
Attention-family continuous batching additionally needs per-slot cache
positions inside attention (per-slot RoPE offsets and scatter writes), as
in the reference.

Host syncs: one per admitted request (its first token) and one per decode
step (the whole argmax vector in one copy).

Throughput accounting: `SchedulerStats.utilization` = busy-slot-tokens /
total-slot-tokens; static batching of mixed-length requests wastes the
difference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import inference


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int = 32
    eos_id: Optional[int] = None
    generated: Optional[List[int]] = None
    done: bool = False


@dataclasses.dataclass
class SchedulerStats:
    steps: int = 0
    admitted: int = 0
    finished: int = 0
    slot_busy_tokens: int = 0
    slot_idle_tokens: int = 0

    @property
    def utilization(self) -> float:
        tot = self.slot_busy_tokens + self.slot_idle_tokens
        return self.slot_busy_tokens / tot if tot else 0.0


def _scatter_slot(slot_state, one_state, slot: int):
    """Copy a batch-1 request state into `slot` of the slot-batched state.

    Leaf convention: any tensor leaf whose shape differs between the trees
    and whose dim-0 is 1 in the small tree is a per-slot state, written into
    the big leaf in place; other leaves (scalars, equal shapes) pass
    through unchanged. Dicts, lists and tuples are walked. Returns the big
    tree.
    """
    if isinstance(slot_state, dict):
        return {k: _scatter_slot(v, one_state[k], slot) for k, v in slot_state.items()}
    if isinstance(slot_state, (list, tuple)):
        return type(slot_state)(
            _scatter_slot(b, s, slot) for b, s in zip(slot_state, one_state))
    big, small = slot_state, one_state
    if not isinstance(big, torch.Tensor) or big.ndim == 0 or big.shape == small.shape:
        return big
    if small.ndim == big.ndim and small.shape[0] == 1:
        big[slot : slot + 1] = small.to(big.dtype)
    return big


class ContinuousBatcher:
    """Slots of ``model``'s decode state on the device of ``params``."""

    def __init__(self, model, params, n_slots: int, max_len: int = 4096):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = _params_device(params)
        st = model.decode_state(n_slots, 1, device=self.device)
        self.state = {**st, "pos": 0}
        self.active: Dict[int, Request] = {}
        self.last_tok = np.zeros((n_slots, 1), np.int32)
        self.stats = SchedulerStats()

    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.active]

    def admit(self, req: Request) -> bool:
        slots = self.free_slots()
        if not slots:
            return False
        slot = slots[0]
        tokens = torch.as_tensor(req.prompt[None, :].astype(np.int32), device=self.device)
        logits, st = self.model.prefill(self.params, {"tokens": tokens, "max_len": self.max_len})
        with inference():
            self.state = {
                **_scatter_slot({k: v for k, v in self.state.items() if k != "pos"},
                                {k: v for k, v in st.items() if k != "pos"}, slot),
                "pos": self.state["pos"],
            }
        tok = int(torch.argmax(logits[0]))
        req.generated = [tok]
        self.last_tok[slot, 0] = tok
        self.active[slot] = req
        self.stats.admitted += 1
        return True

    def _release(self, slot: int):
        req = self.active.pop(slot)
        req.done = True
        self.stats.finished += 1

    def step(self):
        if not self.active:
            return
        logits, self.state = self.model.decode_step(
            self.params, self.state, torch.as_tensor(self.last_tok, device=self.device)
        )
        toks = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()  # one copy a step
        self.stats.steps += 1
        self.stats.slot_busy_tokens += len(self.active)
        self.stats.slot_idle_tokens += self.n_slots - len(self.active)
        for slot in list(self.active):
            req = self.active[slot]
            tok = int(toks[slot])
            req.generated.append(tok)
            if (req.eos_id is not None and tok == req.eos_id) or len(
                req.generated
            ) >= req.max_new:
                self._release(slot)
        self.last_tok = toks[:, None]

    def run(self, requests: List[Request], max_steps: int = 10_000) -> SchedulerStats:
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self.admit(pending[0]):
                pending.pop(0)
            if not self.active and not pending:
                break
            self.step()
        return self.stats


def _params_device(params) -> torch.device:
    """The device of the first tensor leaf of a parameter tree."""
    while isinstance(params, (dict, list, tuple)):
        params = next(iter(params.values())) if isinstance(params, dict) else params[0]
    return params.device
