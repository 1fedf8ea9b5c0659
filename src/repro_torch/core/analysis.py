"""Analytical bounds from the paper's appendices.

Appendix A: the maximum number of shards a document can be split into
while the CAD communication still hides under the context-independent
compute:  s <= 2(t·B - h_q) / h_kv - 1,  where t is the per-token
context-independent compute time, B the interconnect bandwidth, and
h_q/h_kv the query / key-value hidden byte sizes.

The paper evaluates this for Llama-34B on H200+InfiniBand and gets
s ≈ 31 (``tests/test_torch_analysis.py`` reproduces it);
``max_partition_size`` generalizes it to any config and link bandwidth.

The port of ``repro.core.analysis``.  Its defaults are one H100 SXM's
NVLink bandwidth and bf16 peak (``core/cost_model.py``), where the
reference's are its TPU interconnect's.
"""
from __future__ import annotations

from repro_torch.core.cost_model import (BYTES_PER_EL, NVLINK_BW,
                                         PEAK_FLOPS_BF16,
                                         linear_flops_per_token)


def context_independent_time_per_token(cfg, *, peak_flops: float,
                                       mfu: float = 0.5) -> float:
    """App. A: t = 2h(2h + h_kv + 3i) / (mfu·peak), generalized through
    the config's own layer structure (one layer, as in the paper)."""
    per_layer = linear_flops_per_token(cfg) / cfg.n_layers
    return per_layer / (mfu * peak_flops)


def max_partition_size(cfg, *, bandwidth: float = NVLINK_BW,
                       peak_flops: float = PEAK_FLOPS_BF16,
                       mfu: float = 0.5) -> float:
    """s <= 2(tB - size_q) / size_kv - 1 (paper App. A)."""
    t = context_independent_time_per_token(cfg, peak_flops=peak_flops,
                                           mfu=mfu)
    size_q = cfg.n_heads * cfg.head_dim * BYTES_PER_EL
    size_kv = 2 * cfg.n_kv_heads * cfg.head_dim * BYTES_PER_EL  # K and V
    return 2.0 * (t * bandwidth - size_q) / size_kv - 1.0
