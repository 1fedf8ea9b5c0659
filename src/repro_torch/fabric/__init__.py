"""Multi-tenant attention fabric (DESIGN.md §10).

The port of ``repro.fabric``.  One elastic
:class:`~repro_torch.runtime.pool.ServerPool` serves two tenants:
training step-plans (throughput class, owns the pool) and inference
prefill/decode traffic (latency class, backfills idle capacity and
preempts only speculation).  Admission, execution and recovery all run
against one epoch-stamped ``CalibrationSnapshot`` per round, so every
mixed step is deterministic and replayable.
"""
from repro_torch.fabric.executor import FabricExecutor, FabricStepReport
from repro_torch.fabric.tenancy import (LATENCY, SERVE, THROUGHPUT, TRAIN,
                                        AdmissionPolicy, AdmissionRound,
                                        ServeTaskReq, TenantClass,
                                        admit_serve)
from repro_torch.fabric.workload import ServeRequest, ServeWorkload

__all__ = [
    "AdmissionPolicy", "AdmissionRound", "FabricExecutor",
    "FabricStepReport", "LATENCY", "SERVE", "ServeRequest",
    "ServeTaskReq", "ServeWorkload", "THROUGHPUT", "TRAIN",
    "TenantClass", "admit_serve",
]
