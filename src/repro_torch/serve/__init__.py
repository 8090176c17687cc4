"""serve/ — two schedulers over one slot/utilization discipline.

token_scheduler.py: continuous batching of LLM decode slots (Orca/vLLM
style). bank_server.py: microbatched query scoring against a trained
StreamSVM (B, D) bank (kernels B2 / B6 serve, B5 for a kernel bank), with
checkpoint loading and mid-stream bank hot-swap. scheduler.py is a
compatibility shim for the token scheduler's old location.
"""
from .bank_server import BankServer, ScoreRequest, ServerStats
from .token_scheduler import ContinuousBatcher, Request, SchedulerStats

__all__ = [
    "BankServer",
    "ContinuousBatcher",
    "Request",
    "SchedulerStats",
    "ScoreRequest",
    "ServerStats",
]
