"""Layer implementations for the dense decoder: init, norms, RoPE, GQA
projections, self-attention over packed documents and the MLP.

The port of the matching functions of ``repro.models.layers``, with the
same weight names and layouts: weights are stored ``[in, out]`` and
applied as ``h @ W``.  ``*_init`` returns an ``nn.ParameterDict`` of
trainable weights; ``*_apply`` takes that or any mapping of tensors, so a
test can hand in plain tensors.  The reference's sharding constraints
(``ctx.cons``) and its tensor-parallel head padding are no-ops on one
card and are left out.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.attention import core_attention


# ----------------------------------------------------------------- helpers
def dense_init(gen: torch.Generator, fan_in: int, shape, dtype,
               device) -> torch.Tensor:
    """normal(0, 1) * fan_in**-0.5, drawn straight in ``dtype`` on
    ``device`` (no f32 copy of a large bf16 model ever exists)."""
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(fan_in ** -0.5)


def _params(**tensors: torch.Tensor) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


def norm_init(d: int, dtype, kind: str = "rmsnorm",
              device=None) -> nn.ParameterDict:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return _params(**p)


def norm_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               kind: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
        if "bias" in p:
            out = out + p["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [B,S,H,dh], positions [B,S].  Split halves (not interleaved)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(0, half, dtype=torch.float32,
                                      device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def activation_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu2": lambda x: torch.square(F.relu(x))}[name]


# --------------------------------------------------------------- attention
def attn_init(gen: torch.Generator, cfg, device=None) -> nn.ParameterDict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.pdtype
    return _params(
        wq=dense_init(gen, d, (d, hq * dh), dt, device),
        wk=dense_init(gen, d, (d, hkv * dh), dt, device),
        wv=dense_init(gen, d, (d, hkv * dh), dt, device),
        wo=dense_init(gen, hq * dh, (hq * dh, d), dt, device))


def qkv_proj(p: Mapping[str, torch.Tensor], h: torch.Tensor, cfg,
             positions: Optional[torch.Tensor], prefix: str = "w"):
    b, s, _ = h.shape
    dh = cfg.head_dim
    q = (h @ p[prefix + "q"]).reshape(b, s, cfg.n_heads, dh)
    k = (h @ p[prefix + "k"]).reshape(b, s, cfg.n_kv_heads, dh)
    v = (h @ p[prefix + "v"]).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attn_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor, batch,
                    cfg, ctx, *, causal: bool = True, window: int = 0,
                    hook=None) -> torch.Tensor:
    """h [B,S,D]; ``batch`` provides segment_ids/positions [B,S].
    ``hook``, if given, is called with the attention inputs just before
    core attention (an inspection point for tests and the smoke run)."""
    b, s, _ = h.shape
    seg, pos = batch["segment_ids"], batch["positions"]
    q, k, v = qkv_proj(p, h, cfg, pos if cfg.use_rope else None)
    if hook is not None:
        hook(dict(q=q, k=k, v=v, segment_ids=seg, positions=pos, ctx=ctx))
    out = core_attention(q, k, v, seg, pos, seg, pos, causal=causal,
                         window=window, softcap=cfg.attn_logit_softcap,
                         ctx=ctx)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]


# --------------------------------------------------------------------- ffn
def ffn_init(gen: torch.Generator, cfg, device=None) -> nn.ParameterDict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    if cfg.gated_mlp:
        return _params(w_gate=dense_init(gen, d, (d, f), dt, device),
                       w_up=dense_init(gen, d, (d, f), dt, device),
                       w_down=dense_init(gen, f, (f, d), dt, device))
    return _params(w_up=dense_init(gen, d, (d, f), dt, device),
                   w_down=dense_init(gen, f, (f, d), dt, device))


def ffn_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor,
              cfg) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    if "w_gate" in p:
        inner = act(h @ p["w_gate"]) * (h @ p["w_up"])
    else:
        inner = act(h @ p["w_up"])
    return inner @ p["w_down"]
