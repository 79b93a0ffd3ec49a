"""repro_torch.parallel — the runtime pieces of straggler-robust execution:
fault plans, heartbeats, retries and background tasks."""

from .straggler import (FAULT_PLAN_ENV, BackgroundTask, FaultPlan,
                        HeartbeatTracker, InsufficientWorkers, ShardTimeout,
                        WorkerFailure, retry_with_backoff, start_background)

__all__ = ["FAULT_PLAN_ENV", "BackgroundTask", "FaultPlan",
           "HeartbeatTracker", "InsufficientWorkers", "ShardTimeout",
           "WorkerFailure", "retry_with_backoff", "start_background"]
