"""Fault-tolerance runtime of the port: the checkpointed restart loop,
failure classification with capped exponential backoff, range re-issue for
lost and straggling shards, and the elastic restore."""
from .fault_tolerance import (
    DeviceLostError,
    InjectedFailure,
    RetryPolicy,
    RunReport,
    StragglerPolicy,
    default_live_retryable,
    rebalance_ranges,
    remesh_state,
    run_with_restarts,
    runtime_device_errors,
)

__all__ = [
    "DeviceLostError",
    "InjectedFailure",
    "RetryPolicy",
    "RunReport",
    "StragglerPolicy",
    "default_live_retryable",
    "rebalance_ranges",
    "remesh_state",
    "run_with_restarts",
    "runtime_device_errors",
]
