"""model_idle_ms: device-idle ms a step inside the model's forward and
backward: the time of the ``train.forward`` and ``train.backward`` spans
that no kernel's interval covers."""
from cadbench.spans import busy_intervals, idle_us, named


def read(rec):
    spans = named(rec, "train.forward") + named(rec, "train.backward")
    if not spans or not rec.kernels or not rec.steps:
        return None
    busy = busy_intervals(rec.kernels)
    return sum(idle_us(busy, s["start"], s["end"]) for s in spans) \
        / 1e3 / len(rec.steps)
