"""Pipeline parallelism with CAD across stages (the port of
``repro.pipeline_par``)."""
from repro_torch.pipeline_par.pipeline import (model_stage_fn,
                                               pipeline_apply, split_stages,
                                               sum_grads_over_stages,
                                               tick_schedules)

__all__ = ["pipeline_apply", "split_stages", "tick_schedules",
           "model_stage_fn", "sum_grads_over_stages"]
