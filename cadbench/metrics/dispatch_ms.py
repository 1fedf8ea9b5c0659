"""dispatch_ms: device ms a step of the kernels in the ``dispatch`` bucket
(the CAD dispatch's gathers, exchanges and scatter, forward and
backward; the servers' attention kernels are in ``attention``)."""


def read(rec):
    ms = [k["end"] - k["start"] for k in rec.kernels
          if k["bucket"] == "dispatch"]
    if not ms or not rec.steps:
        return None
    return sum(ms) / 1e3 / len(rec.steps)
