"""gemm_ms: device ms a step of the ``matmuls (cuBLAS)`` family."""


def read(rec):
    ms = [k["end"] - k["start"] for k in rec.kernels
          if k["family"] == "matmuls (cuBLAS)"]
    if not ms or not rec.steps:
        return None
    return sum(ms) / 1e3 / len(rec.steps)
