"""Elastic attention-server runtime (DESIGN.md §9).

The port of ``repro.runtime``.  The pool of attention servers is a
mutable, failure-prone resource — not a compile-time constant.  Core
attention's statelessness (the paper's key observation) makes that
cheap: a lost or slow task is recomputed anywhere from the q/k/v shards
the requester still holds.

  ServerPool          membership with explicit epochs: drain / remove /
                      add mid-training; calibrator speed state carries
                      over, new endpoints restart from the base model
  PoolView            immutable per-epoch membership snapshot
  ServerLostError     a server lost during its serve (recovered; any
                      other serve error propagates)
  FaultSchedule       deterministic, seeded fault injection
                      (kill / flap / slow / drain server s at step t)
  build_recovery_plan recovery sub-plans over exactly the lost tasks,
                      built by the primary plan machinery
  ElasticExecutor     fault-tolerant per-server dispatch with
                      exactly-once bit-identical output merging and
                      percentile-deadline straggler speculation
"""
from repro_torch.runtime.executor import ElasticExecutor, StepReport
from repro_torch.runtime.faults import FaultEvent, FaultSchedule
from repro_torch.runtime.pool import (ACTIVE, DEAD, DRAINING,
                                      PoolExhaustedError, PoolView,
                                      ServerLostError, ServerPool)
from repro_torch.runtime.recovery import (RecoveryPlan, assignment_of_plan,
                                          build_recovery_plan,
                                          lost_block_mask, recovery_tasks)

__all__ = [
    "ServerPool", "PoolView", "PoolExhaustedError", "ServerLostError",
    "ACTIVE", "DRAINING", "DEAD",
    "FaultSchedule", "FaultEvent",
    "RecoveryPlan", "build_recovery_plan", "lost_block_mask",
    "assignment_of_plan", "recovery_tasks",
    "ElasticExecutor", "StepReport",
]
