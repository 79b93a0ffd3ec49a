"""repro_torch.parallel — the sharded placement and straggler-robust
execution: mesh-laid-out arrays, their copies and the per-coordinate
collectives (`collectives`), the mesh-resident `ShardedBlockMatrix` and
its recursion (`sharded_blockmatrix`), the LM's logical-axis rules
(`sharding`), int8 gradient compression (`compression`), and fault plans,
heartbeats, retries, background tasks and coded panel solves
(`straggler`)."""

from .collectives import (DistArray, collective_bytes, collective_calls,
                          reset_collective_bytes)
from .sharded_blockmatrix import (ShardedBlockMatrix, SpecRecord,
                                  assert_mesh_resident, grid_spec,
                                  inverse_program, mesh_fingerprint,
                                  panel_spec, record_specs,
                                  sharded_spin_inverse, sharded_spin_solve,
                                  solve_program)
from .sharding import (DEFAULT_RULES, NamedSharding, PartitionSpec,
                       ShardingRules, logical_spec, named_sharding, shard)
from .straggler import (FAULT_PLAN_ENV, BackgroundTask, CodedConfig,
                        CodedLayout, CodedRunReport, FaultPlan,
                        HeartbeatTracker, InsufficientWorkers, PoolReport,
                        ShardTimeout, WorkerFailure, WorkerPool,
                        coded_inverse, generator_is_mds, make_generator,
                        retry_with_backoff, start_background)

__all__ = ["DistArray", "collective_bytes", "collective_calls", "reset_collective_bytes",
           "ShardedBlockMatrix", "SpecRecord", "assert_mesh_resident",
           "grid_spec", "panel_spec", "mesh_fingerprint", "record_specs",
           "sharded_spin_inverse", "sharded_spin_solve",
           "inverse_program", "solve_program",
           "DEFAULT_RULES", "NamedSharding", "PartitionSpec", "ShardingRules",
           "logical_spec", "named_sharding", "shard",
           "FAULT_PLAN_ENV", "BackgroundTask", "CodedConfig", "CodedLayout",
           "CodedRunReport", "FaultPlan", "HeartbeatTracker",
           "InsufficientWorkers", "PoolReport", "ShardTimeout",
           "WorkerFailure", "WorkerPool", "coded_inverse",
           "generator_is_mds", "make_generator", "retry_with_backoff",
           "start_background"]
