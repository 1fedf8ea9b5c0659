"""elementwise_ms: device ms a step of the kernels in no kernel family
(elementwise, index, reduction and the like: ``other``)."""
from cadbench.frozen.trace import OTHER


def read(rec):
    ms = [k["end"] - k["start"] for k in rec.kernels if k["family"] == OTHER]
    if not ms or not rec.steps:
        return None
    return sum(ms) / 1e3 / len(rec.steps)
