"""Compatibility shim: serve/ holds TWO schedulers; import from them.

The LLM continuous batcher lives in ``serve/token_scheduler.py``: a fixed
pool of decode slots, requests admitted as slots free, every decode step
advancing all busy slots together. Its sibling is ``serve/bank_server.py``:
the same slot/utilization discipline applied to StreamSVM bank serving.

This module re-exports the token scheduler's public names, as the
reference's ``serve/scheduler.py`` does.
"""
from .token_scheduler import ContinuousBatcher, Request, SchedulerStats

__all__ = ["ContinuousBatcher", "Request", "SchedulerStats"]
