"""batch_wait_ms: mean host ms of the traced steps' ``train.batch_wait``
spans (``next`` on the planned batch stream: the pull, the wait for the
plan and the ranks' plan agreement)."""
from cadbench.spans import named


def read(rec):
    ms = [(s["end"] - s["start"]) / 1e3
          for s in named(rec, "train.batch_wait")]
    if not ms:
        return None
    return sum(ms) / len(ms)
