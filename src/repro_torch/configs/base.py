"""Model configuration system.

The port's copy of ``repro.configs.base``: the same dataclasses, widths
and ``reduced()`` rule, with torch dtypes in place of ``jnp.dtype``.  The
registry holds the configs the port builds, trains and serves: the dense
stacks (llama3-8b, llama3-34b, smollm-360m, gemma2-2b, mistral-large-123b,
nemotron-4-340b), the recurrent hybrids (mamba2-370m, recurrentgemma-9b),
the MoE stacks (qwen2-moe-a2.7b, llama4-maverick-400b-a17b) and the
cross-attention archs (whisper-large-v3 with its encoder,
llama-3.2-vision-11b).

Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro/configs``; the registry maps ``--arch <id>`` to it.  A config fully
describes the transformer backbone (the modality frontend for [audio]/[vlm]
archs is a stub per DESIGN.md §7).

Layer patterns
--------------
``layer_pattern`` is a repeating tuple of layer-type strings, e.g.
``("local", "global")`` for gemma2 or ``("rglru", "rglru", "local")`` for
recurrentgemma.  ``n_layers`` must be a multiple of the pattern length; the
model stacks parameters as ``[n_layers // period, ...]`` per slot and scans
over super-blocks, keeping the lowered HLO small even for 96-layer models.

Layer types:
  - ``global``  : full causal self-attention
  - ``local``   : sliding-window causal self-attention (``window``)
  - ``cross``   : self-attention + cross-attention to encoder/vision memory
  - ``ssd``     : Mamba-2 state-space duality block (attention-free)
  - ``rglru``   : RecurrentGemma RG-LRU linear-recurrence block
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 1
    n_shared_experts: int = 0     # always-on experts
    d_ff_expert: int = 0          # per-expert intermediate size
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    expert_parallel: bool = False  # shard experts over the "data" axis


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    chunk_size: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0            # 0 -> d_model
    conv_width: int = 4
    block_width: int = 256        # scan chunk for the linear recurrence


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) / vision memory for VLM."""
    n_layers: int = 0
    n_ctx: int = 1500             # precomputed frame/patch embeddings length
    d_model: int = 0              # 0 -> same as decoder d_model
    causal: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | ssm | moe | vlm | audio | hybrid
    source: str                   # citation from the assignment table

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0

    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 4096            # sliding window for "local" layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    activation: str = "silu"      # silu | gelu | relu2
    gated_mlp: bool = True        # 3-matrix gated MLP vs 2-matrix
    post_norms: bool = False      # gemma2-style post-sublayer norms
    scale_embed: bool = False     # gemma-style sqrt(d_model) embed scaling
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    qk_norm: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    cross_attn_period: int = 0    # VLM: every Nth layer is "cross"

    # long_500k applicability: True iff decode cost per token is sub-linear
    # in context for *every* layer, or the arch natively uses windowed attn.
    subquadratic: bool = False

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.layer_pattern) == 0, (
            f"{self.arch_id}: n_layers={self.n_layers} not a multiple of "
            f"pattern {self.layer_pattern}")

    # ---------------------------------------------------------------- util
    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.period

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def has_attention(self) -> bool:
        return any(t in ("global", "local", "cross") for t in self.layer_pattern)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: ≤2 pattern periods,
        d_model≤512, ≤4 experts, small vocab."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) or 0
        head_dim = (d_model // n_heads) if n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else 0
        if n_kv and n_heads % n_kv:
            n_kv = 1
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                d_ff_expert=min(self.moe.d_ff_expert, 128) or 128,
                capacity_factor=8.0,  # no drops in smoke tests
                expert_parallel=False)
        ssm = None
        if self.ssm:
            ssm = dataclasses.replace(self.ssm, d_state=32, head_dim=32,
                                      chunk_size=64)
        rglru = None
        if self.rglru:
            rglru = dataclasses.replace(self.rglru, lru_width=d_model,
                                        block_width=64)
        enc = None
        if self.encoder:
            enc = dataclasses.replace(self.encoder, n_layers=2, n_ctx=24,
                                      d_model=0)
        # Compact long periods (e.g. recurrentgemma's 19-slot pattern) down
        # to the ordered-unique layer types so the smoke variant stays tiny
        # while still covering every layer type of the family.
        pattern = self.layer_pattern
        if len(pattern) > 4:
            pattern = tuple(dict.fromkeys(pattern))
        n_layers = len(pattern) * (2 if len(pattern) == 1 else 1)
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-reduced",
            layer_pattern=pattern,
            n_layers=n_layers,
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64),
            moe=moe, ssm=ssm, rglru=rglru, encoder=enc,
            param_dtype="float32", compute_dtype="float32",
        )

    # ------------------------------------------------------- flops/memory
    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        per_pattern = 0
        for t in self.layer_pattern:
            per_pattern += self._layer_params(t)
        total += self.n_groups * per_pattern
        if self.encoder:
            ed = self.encoder.d_model or d
            # encoder self-attn + ffn per layer
            hq = self.n_heads * self.head_dim
            hkv = self.n_kv_heads * self.head_dim
            total += self.encoder.n_layers * (
                ed * hq * 2 + ed * hkv * 2 + self._ffn_params())
        return total

    def _ffn_params(self) -> int:
        d = self.d_model
        n_mats = 3 if self.gated_mlp else 2
        if self.moe and self.moe.n_experts:
            e = self.moe
            routed = e.n_experts * n_mats * d * e.d_ff_expert
            shared = e.n_shared_experts * n_mats * d * e.d_ff_expert
            router = d * e.n_experts
            return routed + shared + router
        return n_mats * d * self.d_ff

    def _layer_params(self, layer_type: str) -> int:
        d = self.d_model
        if layer_type == "ssd":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            # in_proj produces [z, x, B, C, dt]
            return d * (2 * d_in + 2 * s.n_groups * s.d_state + nh) + d_in * d
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        if layer_type == "rglru":
            r = self.rglru
            w = r.lru_width or d
            # in/gate branches + input/recurrence gates + out proj + lru a
            blk = 2 * d * w + 2 * w * w + w * d + w
            return blk + self._ffn_params()
        if layer_type == "cross":
            attn *= 2  # self + cross attention
        return attn + self._ffn_params()

    def _ffn_active_flops_per_token(self) -> float:
        """MACs per token through the FFN (active experts only for MoE)."""
        n_mats = 3 if self.gated_mlp else 2
        if self.moe and self.moe.n_experts:
            e = self.moe
            return n_mats * self.d_model * e.d_ff_expert \
                * (e.top_k + e.n_shared_experts)
        return n_mats * self.d_model * self.d_ff

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not (self.moe and self.moe.n_experts):
            return self.n_params()
        e = self.moe
        n_mats = 3 if self.activation == "silu" else 2
        d = self.d_model
        inactive = (e.n_experts - e.top_k) * n_mats * d * e.d_ff_expert
        n_moe_layers = self.n_layers  # every pattern slot uses same ffn cfg
        return self.n_params() - n_moe_layers * inactive


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if arch_id.endswith("-reduced"):
        return get_config(arch_id[: -len("-reduced")]).reduced()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (gemma2_2b, llama3_8b, llama3_34b,  # noqa: F401
                   llama4_maverick, llama32_vision, mamba2_370m,
                   mistral_large, nemotron4_340b, qwen2_moe,
                   recurrentgemma_9b, smollm_360m, whisper_large_v3)
