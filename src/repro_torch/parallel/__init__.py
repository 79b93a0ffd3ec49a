"""repro_torch.parallel — the sharded placement and straggler-robust
execution: mesh-laid-out arrays and their copies (`collectives`), the
mesh-resident `ShardedBlockMatrix` and its recursion
(`sharded_blockmatrix`), and fault plans, heartbeats, retries, background
tasks and coded panel solves (`straggler`)."""

from .collectives import (DistArray, collective_bytes,
                          reset_collective_bytes)
from .sharded_blockmatrix import (ShardedBlockMatrix, SpecRecord,
                                  assert_mesh_resident, grid_spec,
                                  inverse_program, mesh_fingerprint,
                                  panel_spec, record_specs,
                                  sharded_spin_inverse, sharded_spin_solve,
                                  solve_program)
from .straggler import (FAULT_PLAN_ENV, BackgroundTask, CodedConfig,
                        CodedLayout, CodedRunReport, FaultPlan,
                        HeartbeatTracker, InsufficientWorkers, PoolReport,
                        ShardTimeout, WorkerFailure, WorkerPool,
                        coded_inverse, generator_is_mds, make_generator,
                        retry_with_backoff, start_background)

__all__ = ["DistArray", "collective_bytes", "reset_collective_bytes",
           "ShardedBlockMatrix", "SpecRecord", "assert_mesh_resident",
           "grid_spec", "panel_spec", "mesh_fingerprint", "record_specs",
           "sharded_spin_inverse", "sharded_spin_solve",
           "inverse_program", "solve_program",
           "FAULT_PLAN_ENV", "BackgroundTask", "CodedConfig", "CodedLayout",
           "CodedRunReport", "FaultPlan", "HeartbeatTracker",
           "InsufficientWorkers", "PoolReport", "ShardTimeout",
           "WorkerFailure", "WorkerPool", "coded_inverse",
           "generator_is_mds", "make_generator", "retry_with_backoff",
           "start_background"]
