"""plan_build_ms: mean host ms of planning a batch the traced steps
trained on: the ``plan.build`` spans (on the plan prefetch thread, some
built during warm-up) matched to the steps by batch id, summed per batch
(a re-plan at pull counts too)."""
from cadbench.spans import by_step, named


def read(rec):
    steps = {s["step"] for s in named(rec, "train.step")}
    ms = [v for k, v in by_step(named(rec, "plan.build")).items()
          if k in steps]
    if not ms:
        return None
    return sum(ms) / len(ms)
