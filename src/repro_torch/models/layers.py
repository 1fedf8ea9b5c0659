"""Layer implementations: init, norms, RoPE, GQA projections,
self-attention over packed documents, cross-attention over a memory
(encoder output or patch embeddings), the MLP, the capacity-routed MoE
with shared experts, the Mamba-2 SSD block
(chunked scan, packed-document aware) and the RecurrentGemma RG-LRU block
(linear recurrence with document resets), and their one-token decode
steps (``_causal_conv`` with its state, ``ssd_decode``,
``rglru_decode``).

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.core.attention import core_attention
from repro_torch.core.dispatch import _GatherRows
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.ssd import ops as ssd_ops


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
def attn_init(gen: torch.Generator, cfg, device=None,
              cross: bool = False) -> nn.ParameterDict:
    """The self-attention projections; with ``cross`` also the
    cross-attention ones (``xwq``/``xwk``/``xwv``/``xwo``) and the 0-d
    tanh gate ``xgate``, which starts at zero (reference
    ``layers.py:74-90``): at init a cross layer adds nothing."""
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.pdtype
    p = dict(wq=dense_init(gen, d, (d, hq * dh), dt, device),
             wk=dense_init(gen, d, (d, hkv * dh), dt, device),
             wv=dense_init(gen, d, (d, hkv * dh), dt, device),
             wo=dense_init(gen, hq * dh, (hq * dh, d), dt, device))
    if cross:
        p.update(xwq=dense_init(gen, d, (d, hq * dh), dt, device),
                 xwk=dense_init(gen, d, (d, hkv * dh), dt, device),
                 xwv=dense_init(gen, d, (d, hkv * dh), dt, device),
                 xwo=dense_init(gen, hq * dh, (hq * dh, d), dt, device),
                 xgate=torch.zeros((), dtype=dt, device=device))
    return _params(**p)


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


def cross_gate(p: Mapping[str, torch.Tensor],
               out: torch.Tensor) -> torch.Tensor:
    """``tanh(xgate) * out``, the gate's tanh in f32 (llama3.2-vision's
    gate; whisper carries one too)."""
    if "xgate" not in p:
        return out
    return torch.tanh(p["xgate"].float()).to(out.dtype) * out


def cross_attn_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor, batch,
                     cfg, ctx) -> torch.Tensor:
    """Cross-attention of h [B,S,D] over ``batch["memory"]`` [B,M,D] (the
    encoder's output or the stub patch embeddings), reference
    ``layers.py:156-182``.  Every real query token sees every valid memory
    row, whatever its document: the queries take segment ``seg_q > 0``,
    the memory segment 1 (or ``memory_mask``), every memory position is
    0, and the attention is non-causal without softcap.  Padding queries
    (segment 0) attend nothing."""
    b, s, _ = h.shape
    dh = cfg.head_dim
    mem = batch["memory"]
    m = mem.shape[1]
    q = (h @ p["xwq"]).reshape(b, s, cfg.n_heads, dh)
    k = (mem @ p["xwk"]).reshape(b, m, cfg.n_kv_heads, dh)
    v = (mem @ p["xwv"]).reshape(b, m, cfg.n_kv_heads, dh)
    mem_mask = batch.get("memory_mask")
    seg_kv = (torch.ones((b, m), dtype=torch.int32, device=h.device)
              if mem_mask is None else mem_mask.to(torch.int32))
    seg_q_x = (batch["segment_ids"] > 0).to(torch.int32)
    pos_kv = torch.zeros((b, m), dtype=torch.int32, device=h.device)
    out = core_attention(q, k, v, seg_q_x, batch["positions"], seg_kv,
                         pos_kv, causal=False, window=0, softcap=0.0,
                         ctx=ctx)
    return cross_gate(p, out.reshape(b, s, cfg.n_heads * dh) @ p["xwo"])


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


# --------------------------------------------------------------------- moe
def moe_init(gen: torch.Generator, cfg, device=None) -> nn.ParameterDict:
    """Routed experts stacked on a leading [E] axis, the router, and the
    shared experts as one gated MLP of width ``d_ff_expert x
    n_shared_experts`` (the reference's names and layouts)."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    dt = cfg.pdtype
    p = dict(router=dense_init(gen, d, (d, e.n_experts), dt, device),
             experts_gate=dense_init(gen, d, (e.n_experts, d, f), dt,
                                     device),
             experts_up=dense_init(gen, d, (e.n_experts, d, f), dt, device),
             experts_down=dense_init(gen, f, (e.n_experts, f, d), dt,
                                     device))
    if e.n_shared_experts:
        fs = f * e.n_shared_experts
        p.update(w_gate=dense_init(gen, d, (d, fs), dt, device),
                 w_up=dense_init(gen, d, (d, fs), dt, device),
                 w_down=dense_init(gen, fs, (fs, d), dt, device))
    return _params(**p)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, in descending
    order, the lower index first among equal values (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor, cfg,
              no_drop: bool = False, group=None):
    """Capacity-based MoE (reference ``models/layers.py:228-331``): each
    token picks its top-k experts, each expert takes at most ``cap``
    tokens, in token order (a stable sort of the flat expert ids; the
    rest are dropped), and the shared experts are added after the routed
    ones.  ``cap = max(1, int(n_tok * top_k / E * capacity_factor))``, or
    ``n_tok`` under ``no_drop`` (serving: routing is then row-independent).

    Dispatch and combine are gathers: each expert slot gathers its
    token's row (``_GatherRows``: its backward sums a token's slots in a
    fixed order), and each token gathers its k slot outputs, a dropped
    choice reading zero, summed over k in order.  Nothing is added with
    atomics, so a step repeats bit for bit on the card.

    Under a CAD process group (``group``) each rank routes its own tokens
    with the capacity of its own count, as the reference routes each data
    shard's tokens; the auxiliary losses are this rank's shares of the
    global values (every rank holds the same number of tokens): the top-1
    counts are summed across the group inside this call, and summed over
    the ranks the shares are the reference's means over all tokens.

    h [B, S, D].  Returns (out [B, S, D], {"moe_lb", "moe_z"} f32)."""
    e = cfg.moe
    b, s, d = h.shape
    act = activation_fn(cfg.activation)
    n_tok, k, n_e = b * s, e.top_k, e.n_experts
    world = 1
    if group is not None:
        if e.expert_parallel:
            raise NotImplementedError(
                f"{cfg.arch_id}: expert parallelism under a CAD process "
                f"group (experts sharded over the ranks, routed globally) "
                f"comes with the sharding rules, ROADMAP queue 1 item 12")
        world = dist.get_world_size(group)
    x = h.reshape(n_tok, d)
    dev = x.device

    logits = (x @ p["router"]).float()                        # [T, E]
    probs = torch.softmax(logits, -1)
    gate_vals, idx = _top_k(probs, k)                         # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    cap = n_tok if no_drop else max(
        1, int(n_tok * k / n_e * e.capacity_factor))
    tk = n_tok * k
    flat_e = idx.reshape(tk)
    sorted_e, order = torch.sort(flat_e, stable=True)
    grp_start = torch.searchsorted(sorted_e, torch.arange(n_e, device=dev))
    rank_sorted = torch.arange(tk, device=dev) - grp_start[sorted_e]
    pos = torch.empty_like(flat_e).scatter_(0, order, rank_sorted)
    in_cap = pos < cap
    n_slots = n_e * cap
    # a dropped choice points past the last slot (the reference's spare
    # slot): its token id lands there and is cut off
    slot = torch.where(in_cap, flat_e * cap + pos, n_slots)   # [Tk]
    token_id = torch.arange(n_tok, device=dev).repeat_interleave(k)
    token_of_slot = torch.full((n_slots + 1,), -1, dtype=torch.long,
                               device=dev)
    token_of_slot[slot] = token_id
    token_of_slot = token_of_slot[:-1]
    live = (token_of_slot >= 0).to(h.dtype)[:, None]

    xs = _GatherRows.apply(x, token_of_slot.clamp(min=0)) * live
    xs = xs.reshape(n_e, cap, d)
    inner = act(torch.bmm(xs, p["experts_gate"])) \
        * torch.bmm(xs, p["experts_up"])
    ys = torch.bmm(inner, p["experts_down"]).reshape(n_slots, d)
    # combine: token t's k choices, each its slot's output times its gate
    # (in h's dtype), summed in the order of the choices
    w = torch.where(in_cap, gate_vals.reshape(tk).to(h.dtype), 0)
    picked = _GatherRows.apply(ys, slot.clamp(max=n_slots - 1)) \
        * w[:, None]
    picked = picked.reshape(n_tok, k, d)
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]

    if e.n_shared_experts and "w_gate" in p:
        out = out + ((act(x @ p["w_gate"]) * (x @ p["w_up"]))
                     @ p["w_down"])

    # aux losses: Switch-style load balance and the router z-loss
    lse2 = torch.logsumexp(logits, -1) ** 2
    top1 = F.one_hot(idx[:, 0], n_e)
    if group is None:
        me = probs.mean(0)
        ce = top1.float().mean(0)
        lb = n_e * torch.sum(me * ce) * e.load_balance_loss
        z = lse2.mean() * e.router_z_loss
    else:
        counts = top1.sum(0)
        dist.all_reduce(counts, group=group)
        n_glob = n_tok * world
        ce = counts.float() / n_glob
        lb = n_e * torch.sum(probs.sum(0) / n_glob * ce) \
            * e.load_balance_loss
        z = lse2.sum() / n_glob * e.router_z_loss
    return out.reshape(b, s, d).to(h.dtype), {"moe_lb": lb, "moe_z": z}


# -------------------------------------------------------------- mamba2 SSD
def ssd_init(gen: torch.Generator, cfg, device=None) -> nn.ParameterDict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    dt = cfg.pdtype
    p = _params(
        # fused input projection -> [z (d_in), x (d_in), B, C (G*N each),
        # dt (nh)]
        in_proj=dense_init(gen, d, (d, 2 * d_in + 2 * s.n_groups * s.d_state
                                    + nh), dt, device),
        conv_w=dense_init(gen, s.conv_width, (s.conv_width, conv_ch), dt,
                          device),
        conv_b=torch.zeros(conv_ch, dtype=dt, device=device),
        A_log=torch.log(torch.linspace(1.0, 16.0, nh, device=device)).to(dt),
        D_skip=torch.ones(nh, dtype=dt, device=device),
        dt_bias=torch.zeros(nh, dtype=dt, device=device),
        out_proj=dense_init(gen, d_in, (d_in, d), dt, device))
    p["out_norm"] = norm_init(d_in, dt, device=device)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 first: Optional[torch.Tensor] = None):
    """x [B,S,C]; w [W,C] depthwise causal conv, as shifted sums (not
    ``F.conv1d``: cuDNN runs f32 convolutions in TF32 by default).
    ``state`` [B,W-1,C], if given, is the previous W-1 inputs (decode);
    without it the sequence starts from zeros.  ``first`` [B,S] marks
    document starts: taps reaching across a boundary are zeroed so packed
    documents do not leak into each other.  Returns (silu(conv + b), the
    last W-1 inputs: the next decode state)."""
    width = w.shape[0]
    s = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    if first is not None:
        nr = torch.cumsum(first.to(torch.int32), dim=1)          # [B,S]
        nrp = F.pad(nr, (width - 1, 0), value=-1)
        ys = sum(xp[:, i:i + s, :] * w[i]
                 * (nrp[:, i:i + s] == nr)[..., None].to(x.dtype)
                 for i in range(width))
    else:
        ys = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else None
    return F.silu(ys + b), new_state


def _ssd_split(p: Mapping[str, torch.Tensor], h: torch.Tensor, cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    proj = h @ p["in_proj"]
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * gn]
    dt = proj[..., -nh:]
    return z, xbc, dt, d_in, nh, gn


def ssd_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor, batch, cfg,
              ctx, hook=None) -> torch.Tensor:
    """Mamba-2 SSD block (chunked scan), packed-document aware: the decay
    is zeroed at document starts so state never crosses documents.
    ``hook``, if given, is called with the intra-chunk step's arguments
    (see ``_ssd_chunked``)."""
    s = cfg.ssm
    b, S, _ = h.shape
    seg = batch["segment_ids"]
    first = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                       seg[:, 1:] != seg[:, :-1]], dim=1)
    z, xbc, dt, d_in, nh, gn = _ssd_split(p, h, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"], first=first)
    x = xbc[..., :d_in].reshape(b, S, nh, s.head_dim)
    B_ = xbc[..., d_in:d_in + gn].reshape(b, S, s.n_groups, s.d_state)
    C_ = xbc[..., d_in + gn:].reshape(b, S, s.n_groups, s.d_state)

    A = -torch.exp(p["A_log"].float())                         # [nh] < 0
    dt = F.softplus(dt.float() + p["dt_bias"].float())         # [B,S,nh]
    log_a = dt * A                                             # <= 0
    y = _ssd_chunked(x, dt, log_a, B_, C_, s.chunk_size, first, ctx=ctx,
                     hook=hook)
    y = y + x * p["D_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, S, d_in)
    y = norm_apply(p["out_norm"], y * F.silu(z))
    return y @ p["out_proj"]


def _ssd_chunked(x, dt, log_a, B_, C_, chunk, first, ctx=None, hook=None):
    """Chunked SSD: y_t = C_t^T ( sum_{j<=t} prod_{i in (j,t]} a_i *
    dt_j B_j x_j^T ).  x [B,S,H,P]; B_/C_ [B,S,G,N]; log_a/dt [B,S,H];
    first [B,S] bool marks document starts (state resets).  Returns
    y [B,S,H,P] in x's dtype.

    Document resets are not folded into log_a as -inf (the
    cumsum-difference trick would suffer catastrophic cancellation); the
    reset-count prefix sum gates which (j -> i) contributions are allowed.
    ``ctx.attn_impl == "pallas"`` runs the intra-chunk step in the CUDA
    kernels (``kernels/ssd``) with the G-sized B and C, and x, B and C in
    their own (compute) dtype: bf16 goes to the tensor-core kernels, f32
    to the exact FMA kernels.  Every other implementation runs the
    reference's einsum route in torch ops, on f32 casts.  ``hook``, if
    given, is called with the kernel route's arguments (C, B, x, dt,
    csum, nr) before the intra-chunk step."""
    b, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} must divide into ssd chunks of {chunk}")
    nc = S // chunk

    def r(t):  # [B,S,...] -> [B,nc,chunk,...]
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc, lac, fc = r(x), r(dt), r(log_a), r(first)
    Cc = r(C_).float()                              # [B,K,c,G,N]
    # a_t at a reset position never multiplies anything that survives the
    # reset-count gates below, so zero its log contribution.
    lac = torch.where(fc[..., None], 0.0, lac)
    nr = torch.cumsum(fc.to(torch.int32), dim=2, dtype=torch.int32)
    csum = torch.cumsum(lac, dim=2)                 # [B,K,c,H]
    # intra-chunk: input j reaches output i (j<=i) decayed by
    # exp(csum_i - csum_j), weighted by dt_j, when no reset occurred in
    # (j, i] <=> nr_i == nr_j; chunk-final states over inputs j with no
    # reset after them (nr_j == nr_last)
    if getattr(ctx, "attn_impl", "") == "pallas":
        args = dict(C=r(C_), B=r(B_), x=xc, dt=dtc, csum=csum, nr=nr)
        if hook is not None:
            hook(args)
        y_intra, states = ssd_ops.ssd_chunk(**args)
    else:
        # the reference's einsum route: the plain version, differentiated
        # by autograd
        y_intra, states = ssd_ops.ssd_chunk_fwd_reference(
            C=Cc, B=r(B_).float(), x=xc.float(), dt=dtc, csum=csum, nr=nr)
    # carried decay is zero if the chunk contains any reset
    no_reset = (nr[:, :, -1] == 0)[..., None]             # [B,K,1]
    chunk_decay = torch.exp(csum[:, :, -1, :].clamp(-80.0, 0.0)) \
        * no_reset.float()                                # [B,K,H]
    # the inter-chunk recurrence (the reference's lax.scan)
    h_prev = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    h_before = []
    for k in range(nc):
        h_before.append(h_prev)
        h_prev = h_prev * chunk_decay[:, k, :, None, None] + states[:, k]
    h_before = torch.stack(h_before, dim=1)       # [B,K,H,N,P] entering
    # inter-chunk: y_i += C_i^T decay(start..i) h_before, gated on no reset
    # having occurred at or before i within this chunk; each group's C
    # against its heads' states, without repeating C per head
    dec_in = torch.exp(csum.clamp(-80.0, 0.0)) \
        * (nr == 0).float()[..., None]                    # [B,K,c,H]
    y_inter = torch.einsum("bkign,bkgrnp->bkigrp", Cc,
                           h_before.reshape(b, nc, G, rep, N, P))
    y_inter = y_inter.reshape(b, nc, chunk, H, P) * dec_in[..., None]
    y = (y_intra + y_inter).reshape(b, S, H, P)
    return y.to(x.dtype)


# ------------------------------------------------------------------ rg-lru
def rglru_init(gen: torch.Generator, cfg, device=None) -> nn.ParameterDict:
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    dt = cfg.pdtype
    # a initialised so that a = sigmoid(lru_a)^8 is in ~[0.9, 0.999]
    a_init = torch.log(torch.expm1(
        torch.linspace(0.9, 0.999, w) ** (1 / 8.0)) + 1e-8)
    return _params(
        w_x=dense_init(gen, d, (d, w), dt, device),         # recurrence in
        w_gate_br=dense_init(gen, d, (d, w), dt, device),   # gelu branch
        conv_w=dense_init(gen, r.conv_width, (r.conv_width, w), dt, device),
        conv_b=torch.zeros(w, dtype=dt, device=device),
        w_input_gate=dense_init(gen, w, (w, w), dt, device),
        w_rec_gate=dense_init(gen, w, (w, w), dt, device),
        lru_a=a_init.to(dtype=dt, device=device),
        w_out=dense_init(gen, w, (w, d), dt, device))


_LRU_C = 8.0


def rglru_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor, batch, cfg,
                ctx, hook=None) -> torch.Tensor:
    """Griffin RG-LRU temporal-mixing block with document resets.
    ``hook``, if given, is called with the scan's arguments (see
    ``_rglru_scan``)."""
    b, S, _ = h.shape
    seg = batch["segment_ids"]
    first = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                       seg[:, 1:] != seg[:, :-1]], dim=1)
    gate_br = F.gelu(h @ p["w_gate_br"], approximate="tanh")
    x = h @ p["w_x"]
    x, _ = _causal_conv(x, p["conv_w"], p["conv_b"], first=first)
    y = _rglru_scan(p, x, first, ctx=ctx, hook=hook)
    y = y * gate_br
    return y @ p["w_out"]


def _rglru_gates(p: Mapping[str, torch.Tensor], x: torch.Tensor):
    rg = torch.sigmoid(x @ p["w_rec_gate"]).float()
    ig = torch.sigmoid(x @ p["w_input_gate"]).float()
    log_a0 = F.logsigmoid(p["lru_a"].float())
    log_a = _LRU_C * rg * log_a0                       # [B,S,W] (<= 0)
    return log_a, ig


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) with ``jnp.clip``'s gradient: 1 inside, 1/2 at a bound
    (``torch.clamp`` would pass all of it), 0 outside."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _rglru_scan(p, x, first, ctx=None, hook=None):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t x_t), a_t = 0 at document
    starts; returns h in x's dtype.  ``ctx.attn_impl == "pallas"`` with
    the channel and sequence lengths multiples of 128 (the reference's
    condition) runs the recurrence in the CUDA kernels (``lru_scan``),
    after calling ``hook``, if given, with its f32 arguments ``a`` and
    ``bterm``; every other case runs the plain forward under autograd
    (the reference's ``associative_scan`` route)."""
    log_a, ig = _rglru_gates(p, x)
    log_a = torch.where(first[..., None], -1e30, log_a)
    a = torch.exp(log_a)
    beta = torch.sqrt(_clip01(1.0 - torch.exp(2.0 * log_a)))
    bterm = beta * ig * x.float()
    w, s = x.shape[-1], x.shape[1]
    if getattr(ctx, "attn_impl", "") == "pallas" and w % 128 == 0 \
            and s % 128 == 0:
        if hook is not None:
            hook(dict(a=a, bterm=bterm))
        return rglru_ops.lru_scan(a, bterm).to(x.dtype)
    return rglru_ops.lru_scan_fwd_reference(a, bterm).to(x.dtype)


# ------------------------------------------------------ recurrent decoding
def rglru_decode(p: Mapping[str, torch.Tensor], x_t: torch.Tensor,
                 h_prev: torch.Tensor,
                 reset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One RG-LRU step: x_t [B,1,W] (after the conv), h_prev [B,W] f32;
    ``reset`` [B] bool zeroes the decay (a document start), as the packed
    forward does at segment boundaries.  Returns h [B,W] f32."""
    log_a, ig = _rglru_gates(p, x_t)
    a = torch.exp(log_a[:, 0])
    if reset is not None:
        a = torch.where(reset[:, None], 0.0, a)
    beta = torch.sqrt(_clip01(1.0 - a * a))
    return a * h_prev + beta * ig[:, 0] * x_t[:, 0].float()


def ssd_decode(p: Mapping[str, torch.Tensor], h_t: torch.Tensor,
               conv_state: torch.Tensor, ssm_state: torch.Tensor, cfg):
    """One SSD step.  h_t [B,1,D]; conv_state [B,W-1,C]; ssm_state
    [B,H,N,P] f32.  Returns (out [B,1,D], conv_state, ssm_state)."""
    s = cfg.ssm
    b = h_t.shape[0]
    z, xbc, dt, d_in, nh, gn = _ssd_split(p, h_t, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x = xbc[:, 0, :d_in].reshape(b, nh, s.head_dim)
    rep = nh // s.n_groups
    B_ = xbc[:, 0, d_in:d_in + gn].reshape(b, s.n_groups, s.d_state) \
        .repeat_interleave(rep, dim=1)                         # [B,H,N]
    C_ = xbc[:, 0, d_in + gn:].reshape(b, s.n_groups, s.d_state) \
        .repeat_interleave(rep, dim=1)
    A = -torch.exp(p["A_log"].float())
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # [B,H]
    a = torch.exp(dtv * A)                                     # [B,H]
    upd = (dtv[..., None] * B_.float())[..., None] \
        * x.float()[:, :, None, :]                             # [B,H,N,P]
    ssm_state = ssm_state * a[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", C_.float(), ssm_state)
    y = y + x.float() * p["D_skip"].float()[None, :, None]
    y = y.reshape(b, 1, d_in).to(h_t.dtype)
    y = norm_apply(p["out_norm"], y * F.silu(z))
    return y @ p["out_proj"], conv_state, ssm_state
