"""The port's Appendix A bound (``repro_torch.core.analysis``) against the
reference's (``repro.core.analysis``): the paper's s ≈ 31 for Llama-34B,
the bound's growth with model size, and every attention arch the port
has sharding at least a little, at the reference's link and at the
port's own defaults (one H100's NVLink and bf16 peak)."""
import pytest

from repro.configs import get_config as jax_config
from repro.core.analysis import max_partition_size as j_bound
from repro_torch.configs import get_config, list_archs
from repro_torch.core import cost_model
from repro_torch.core.analysis import (context_independent_time_per_token,
                                       max_partition_size)

# every arch the port registers that has attention, besides the
# attention-free mamba2
ATTN_ARCHS = [a for a in list_archs() if get_config(a).has_attention()]


def test_paper_appendix_a_llama34b():
    """Paper: Llama-34B config (h=8192, h_kv=2048, i=22016), 50 GB/s IB,
    50% MFU of a 990 TFLOP/s H200 -> s ≈ 31."""
    cfg = get_config("llama3-34b")
    s = max_partition_size(cfg, bandwidth=50e9, peak_flops=990e12, mfu=0.5)
    assert 25 <= s <= 38, s
    assert s == pytest.approx(j_bound(jax_config("llama3-34b"),
                                      bandwidth=50e9, peak_flops=990e12,
                                      mfu=0.5), rel=1e-12)


def test_bound_grows_with_model_size():
    """Paper: 'for larger models, this upper bound even increases.'"""
    sizes = ["llama3-8b", "llama3-34b", "mistral-large-123b",
             "nemotron-4-340b"]
    s = [max_partition_size(get_config(a)) for a in sizes]
    assert s == sorted(s), dict(zip(sizes, s))


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_bound_matches_reference_and_is_positive(arch):
    """At the reference's own default link and peak the port's bound is
    the reference's; every attention arch can shard at least a little."""
    from repro.core import cost_model as jcm
    got = max_partition_size(get_config(arch), bandwidth=jcm.ICI_BW,
                             peak_flops=jcm.PEAK_FLOPS_BF16)
    assert got == pytest.approx(j_bound(jax_config(arch)), rel=1e-12)
    assert max_partition_size(get_config(arch)) > 1, arch


def test_port_defaults_are_the_cards():
    """The port's defaults are one H100 SXM's NVLink bandwidth and bf16
    peak: llama3-34b's bound there is the formula's at those constants."""
    cfg = get_config("llama3-34b")
    t = context_independent_time_per_token(
        cfg, peak_flops=cost_model.PEAK_FLOPS_BF16)
    want = 2.0 * (t * cost_model.NVLINK_BW - 64 * 128 * 2) \
        / (2 * 16 * 128 * 2) - 1.0
    assert max_partition_size(cfg) == pytest.approx(want, rel=1e-12)
    assert max_partition_size(cfg) == max_partition_size(
        cfg, bandwidth=450e9, peak_flops=989e12, mfu=0.5)
