"""optimizer_ms: device ms a step of the kernels whose launching runtime
call falls inside an ``optim.update`` span (the gradients' clip norm and
AdamW)."""
from cadbench.spans import named


def read(rec):
    spans = named(rec, "optim.update")
    if not spans or not rec.steps:
        return None
    return sum(s["kernel_us"] for s in spans) / 1e3 / len(rec.steps)
