"""Core attention disaggregation as a service (paper §4; DistCA).

The port of ``repro.cad``:

  CADSession          owns pool config, ping-pong, tolerance and plan
                      policy; builds contexts and plans
  StepPlan            one step's dispatch plan (host arrays; ``to(device)``)
  PingPongPlan        the two nano-batch plans of a ping-pong step
  register_planner /  string-keyed plan-policy registry
  get_planner         ("identity" | "per_doc_cp" | "balanced" | "ring")
  PlanPrefetcher      async host-side plan prefetch (bounded queue)
  PlanCapacityError   static-capacity overflow diagnostics
  PlanMemoryError     no feasible split fits the HBM budgets
"""
from repro_torch.cad.planner import (PlanResult, Planner, available_policies,
                                     get_planner, register_planner)
from repro_torch.cad.prefetch import PlanPrefetcher
from repro_torch.cad.session import CADSession
from repro_torch.core.plan import (CADConfig, PingPongPlan, PlanCapacityError,
                                   PlanMemoryError, StepPlan)

__all__ = [
    "CADSession", "StepPlan", "PingPongPlan", "CADConfig",
    "PlanCapacityError", "PlanMemoryError", "Planner",
    "PlanResult", "register_planner",
    "get_planner", "available_policies", "PlanPrefetcher",
]
