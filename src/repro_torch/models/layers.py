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
test can hand in plain tensors.  On one card the reference's sharding
constraints (``ctx.cons``) are no-ops and are left out; on a ``("data",
"model")`` grid (``ctx.tp``) every layer takes the residual's sequence
shard and gathers the sequence over the model ranks: the attention, FFN,
MoE and RG-LRU layers work on this rank's heads, FFN columns, expert
width or recurrence channels and reduce-scatter their partial outputs
(``models.sharded``), the MoE routes over the data ranks (expert
parallelism) where the config asks for it, the SSD mixer (replicated over
``"model"`` by the reference's rules) runs whole on every model rank and
keeps its shard of the output, and cross-attention attends this rank's
query shard to the whole memory.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.core.attention import core_attention
from repro_torch.core.dispatch import _GatherRows
from repro_torch.models import sharded as S
from repro_torch.obs.regions import marked
from repro_torch.parallel import head_pad
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
    """q/k/v ``[B, S, heads, dh]``, as many heads as the weights' columns
    hold (a grid rank's shards hold its own)."""
    b, s, _ = h.shape
    dh = cfg.head_dim
    q, k, v = (h @ p[prefix + n] for n in "qkv")
    q, k, v = (t.reshape(b, s, t.shape[-1] // dh, dh) for t in (q, k, v))
    if cfg.use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attn_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor, batch,
                    cfg, ctx, *, causal: bool = True, window: int = 0,
                    hook=None) -> torch.Tensor:
    """h [B,S,D]; ``batch`` provides segment_ids/positions [B,S].
    ``hook``, if given, is called with the attention inputs just before
    core attention (an inspection point for tests and the smoke run).

    On a grid (``ctx.tp``; reference ``self_attn_apply`` under a mesh)
    ``h`` is the residual's sequence shard: q/k/v are projected from the
    whole sequence on this rank's heads (``tp_heads``) and the ``wo``
    output's sequence shard, summed over the model ranks, is returned.
    Where the ``heads`` rule splits the heads, ``wq``'s columns and
    ``wo``'s rows are stored as this rank's; otherwise they are sliced
    from the replicated tensors, and ``tp_local_heads`` pads the heads."""
    tp = getattr(ctx, "tp", False)
    x = S.seq_gather(h, ctx.model_group) if tp else h
    b, s, _ = x.shape
    seg, pos = batch["segment_ids"], batch["positions"]
    w = {n: p[n] for n in ("wq", "wk", "wv", "wo")}
    n_real = cfg.n_heads
    if tp:
        grid = (ctx.rules, ctx.model_size, S.model_rank(ctx))
        lo, n_real, _ = tp_heads(cfg, *grid)
        if ctx.rules.heads is None:
            cols = slice(lo * cfg.head_dim, (lo + n_real) * cfg.head_dim)
            w.update(wq=w["wq"][:, cols], wo=w["wo"][cols])
    q, k, v = qkv_proj(w, x, cfg, pos if cfg.use_rope else None)
    if tp:
        q, k, v = tp_local_heads(q, k, v, cfg, *grid)
    if hook is not None:
        hook(dict(q=q, k=k, v=v, segment_ids=seg, positions=pos, ctx=ctx))
    out = core_attention(q, k, v, seg, pos, seg, pos, causal=causal,
                         window=window, softcap=cfg.attn_logit_softcap,
                         ctx=ctx)
    out = out[:, :, :n_real].reshape(b, s, n_real * cfg.head_dim) @ w["wo"]
    return S.seq_scatter(out, ctx.model_group) if tp else out


def tp_heads(cfg, rules, model_size: int, model_index: int):
    """This model rank's q heads on the grid: (first head, real heads,
    heads it attends with).  Where the ``heads`` rule splits them each
    rank takes ``n_heads / M``; otherwise (the reference's
    ``_pad_heads_for_tp``, ``models/layers.py:113-130``) the heads are
    padded to ``head_pad`` and each rank takes ``head_pad / M``, the last
    ones zero heads, cut off before ``wo``."""
    hq = cfg.n_heads
    if rules.heads is not None:
        per = hq // model_size
        return model_index * per, per, per
    per = head_pad(hq, model_size) // model_size
    lo = model_index * per
    return lo, max(0, min(per, hq - lo)), per


def tp_local_heads(q, k, v, cfg, rules, model_size: int, model_index: int):
    """The q/k/v this model rank attends with, from ``q [B, S, n_real,
    dh]`` (its real heads) and ``k``/``v`` (its kv heads where the
    ``kv_heads`` rule splits them, else all ``n_kv_heads``): unsplit kv is
    repeated to one head a q head and cut to this rank's (MHA,
    ``core/dispatch.py:943-951`` of the reference), and zero heads pad q,
    k and v to ``tp_heads``'s count, as the reference's
    ``_pad_heads_for_tp`` pads its whole tensors."""
    lo, n_real, per = tp_heads(cfg, rules, model_size, model_index)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if rules.kv_heads is None:
        kv = torch.arange(lo, lo + n_real, device=q.device) // (hq // hkv)
        k, v = k[:, :, kv], v[:, :, kv]
    if per > n_real:
        pad = (0, 0, 0, per - n_real)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    return q, k, v


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
    (segment 0) attend nothing.  On a grid (``ctx.tp``) ``h`` is the
    residual's sequence shard and the cross weights are whole on every
    model rank (the reference's rules replicate them over ``"model"``):
    the rank's queries, with its shard of ``segment_ids`` and
    ``positions``, attend the whole memory, and the output is its shard
    already."""
    b, s, _ = h.shape
    dh = cfg.head_dim
    mem = batch["memory"]
    m = mem.shape[1]
    seg_q, pos_q = batch["segment_ids"], batch["positions"]
    if getattr(ctx, "tp", False):
        seg_q, pos_q = S.own_seq(seg_q, ctx), S.own_seq(pos_q, ctx)
    q = (h @ p["xwq"]).reshape(b, s, cfg.n_heads, dh)
    k = (mem @ p["xwk"]).reshape(b, m, cfg.n_kv_heads, dh)
    v = (mem @ p["xwv"]).reshape(b, m, cfg.n_kv_heads, dh)
    mem_mask = batch.get("memory_mask")
    seg_kv = (torch.ones((b, m), dtype=torch.int32, device=h.device)
              if mem_mask is None else mem_mask.to(torch.int32))
    seg_q_x = (seg_q > 0).to(torch.int32)
    pos_kv = torch.zeros((b, m), dtype=torch.int32, device=h.device)
    out = core_attention(q, k, v, seg_q_x, pos_q, seg_kv,
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
              cfg, ctx=None) -> torch.Tensor:
    """The MLP.  On a grid whose ``ffn`` rule splits it (``ctx.tp``), h is
    the residual's sequence shard: the whole sequence meets this rank's
    columns of ``w_gate``/``w_up`` and rows of ``w_down``, and the partial
    sums are reduce-scattered.  Otherwise it runs on the tokens it is
    given."""
    split = getattr(ctx, "tp", False) and ctx.rules.ffn is not None
    if split:
        h = S.seq_gather(h, ctx.model_group)
    out = _mlp(p, h, activation_fn(cfg.activation))
    return S.seq_scatter(out, ctx.model_group) if split else out


def _mlp(p, x, act):
    if "w_gate" in p:
        inner = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        inner = act(x @ p["w_up"])
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


def _slot_table(flat_e: torch.Tensor, n_e: int, cap: int):
    """Each choice's slot in its expert's queue, in the order of
    ``flat_e`` (a stable sort of the flat expert ids): returns (in_cap,
    slot; a dropped choice points past the last slot, the reference's
    spare one)."""
    tk = flat_e.shape[0]
    dev = flat_e.device
    sorted_e, order = torch.sort(flat_e, stable=True)
    grp_start = torch.searchsorted(sorted_e, torch.arange(n_e, device=dev))
    rank_sorted = torch.arange(tk, device=dev) - grp_start[sorted_e]
    pos = torch.empty_like(flat_e).scatter_(0, order, rank_sorted)
    in_cap = pos < cap
    return in_cap, torch.where(in_cap, flat_e * cap + pos, n_e * cap)


def _token_of_slot(slot, n_tok: int, k: int, n_slots: int):
    """The token in each of ``n_slots`` slots (-1: empty), from each
    choice's slot (token-major choices; a dropped one's spare slot is cut
    off)."""
    out = torch.full((n_slots + 1,), -1, dtype=torch.long,
                     device=slot.device)
    out[slot] = torch.arange(n_tok, device=slot.device).repeat_interleave(k)
    return out[:-1]


@marked("moe_experts")
def _experts(p, xs, act, lo: int, n: int, whole: bool = True):
    """Experts ``[lo, lo + n)`` on ``xs [n, cap, D]``: from tensors that
    hold all E experts (``whole``), or just these (stored split by the
    ``experts`` rule)."""
    wg, wu, wd = p["experts_gate"], p["experts_up"], p["experts_down"]
    if whole:
        wg, wu, wd = wg[lo:lo + n], wu[lo:lo + n], wd[lo:lo + n]
    inner = act(torch.bmm(xs, wg)) * torch.bmm(xs, wu)
    return torch.bmm(inner, wd)


def _combine(ys, slot, w, n_tok, k):
    """Token t's k choices, each its slot's output times its gate (0 for a
    dropped choice), summed in the order of the choices."""
    picked = _GatherRows.apply(ys, slot) * w[:, None]
    picked = picked.reshape(n_tok, k, -1)
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]
    return out


def _route_local(p, x, idx, gate_vals, cap, cfg, act):
    """Route x [T, D]'s top-k choices through all E experts, ``cap``
    tokens an expert in token order."""
    e = cfg.moe
    n_tok, d = x.shape
    k, n_e = e.top_k, e.n_experts
    in_cap, slot = _slot_table(idx.reshape(-1), n_e, cap)
    n_slots = n_e * cap
    token_of_slot = _token_of_slot(slot, n_tok, k, n_slots)
    live = (token_of_slot >= 0).to(x.dtype)[:, None]
    xs = _GatherRows.apply(x, token_of_slot.clamp(min=0)) * live
    ys = _experts(p, xs.reshape(n_e, cap, d), act, 0, n_e) \
        .reshape(n_slots, d)
    w = torch.where(in_cap, gate_vals.reshape(-1).to(x.dtype), 0)
    return _combine(ys, slot.clamp(max=n_slots - 1), w, n_tok, k)


def _route_expert_parallel(p, x, idx, gate_vals, cfg, act, group,
                           no_drop, whole):
    """Expert parallelism over ``group`` (the data ranks): rank r computes
    experts ``[r E/D, (r+1) E/D)``; routing is global, as the reference's
    at ``n_groups = 1``.  Every rank gathers the ranks' expert ids (rows
    rank-major: the global token order) and derives the same slot table,
    with the capacity of the global token count; the token rows go to
    their experts' ranks and the outputs come back (``exchange_rows``),
    sent in slot order, received by source rank and then slot.  ``whole``:
    the expert tensors hold all E experts (no grid's ``experts`` rule
    split them)."""
    e = cfg.moe
    n_tok, d = x.shape
    k, n_e = e.top_k, e.n_experts
    n_ranks, r = dist.get_world_size(group), dist.get_rank(group)
    if n_e % n_ranks:
        raise ValueError(f"{cfg.arch_id}: {n_e} experts do not split over "
                         f"{n_ranks} expert-parallel ranks")
    e_loc = n_e // n_ranks
    dev = x.device
    n_glob = n_tok * n_ranks
    cap = n_glob if no_drop else max(
        1, int(n_glob * k / n_e * e.capacity_factor))
    in_cap, slot = _slot_table(S.all_gather(idx, group).reshape(-1), n_e,
                               cap)
    per_rank = e_loc * cap
    mine = slice(r * n_tok * k, (r + 1) * n_tok * k)
    my_in = in_cap[mine]
    if x.device.type == "meta":
        # a dry run's shapes (``launch.dryrun_lib``): which choices stay
        # and where they go depend on values meta tensors do not hold;
        # take the routing the capacity is sized for, every choice kept
        # and each rank's experts taking an even share of every rank's
        n_keep = min(n_tok * k, per_rank) // n_ranks
        send = recv = [n_keep] * n_ranks
        send_idx, live = (torch.empty(n_keep * n_ranks, dtype=torch.long,
                                      device=dev) for _ in range(2))
    else:
        token_of_slot = _token_of_slot(slot, n_glob, k, n_e * cap)
        my_slot = slot[mine]
        # sends: this rank's kept choices in slot order (so by owner)
        send_idx = torch.nonzero(my_in)[:, 0]
        send_idx = send_idx[torch.argsort(my_slot[send_idx], stable=True)]
        send = torch.bincount(my_slot[send_idx] // per_rank,
                              minlength=n_ranks).tolist()
        # receives: this rank's live slots by source rank, then slot
        tok = token_of_slot[r * per_rank:(r + 1) * per_rank]
        live = torch.nonzero(tok >= 0)[:, 0]
        src = tok[live] // n_tok
        live = live[torch.argsort(src * per_rank + live, stable=True)]
        recv = torch.bincount(src, minlength=n_ranks).tolist()
    rows = S.exchange_rows(_GatherRows.apply(x, send_idx // k), send, recv,
                           group)
    at = torch.full((per_rank,), live.shape[0], dtype=torch.long,
                    device=dev)
    at[live] = torch.arange(live.shape[0], device=dev)
    xs = _GatherRows.apply(torch.cat([rows, rows.new_zeros((1, d))]), at)
    ys = _experts(p, xs.reshape(e_loc, cap, d), act, r * e_loc, e_loc,
                  whole).reshape(per_rank, d)
    back = S.exchange_rows(_GatherRows.apply(ys, live), recv, send, group)
    at = torch.full((n_tok * k,), send_idx.shape[0], dtype=torch.long,
                    device=dev)
    at[send_idx] = torch.arange(send_idx.shape[0], device=dev)
    w = torch.where(my_in, gate_vals.reshape(-1).to(x.dtype), 0)
    return _combine(torch.cat([back, back.new_zeros((1, d))]), at, w,
                    n_tok, k)


def moe_apply(p: Mapping[str, torch.Tensor], h: torch.Tensor, cfg,
              no_drop: bool = False, group=None, ctx=None):
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

    Under a CAD process group (``group``, the data ranks) each rank routes
    its own tokens with the capacity of its own count, as the reference
    routes each data shard's tokens; with ``expert_parallel`` routing is
    global instead, over experts split across the ranks
    (``_route_expert_parallel``).  On a grid (``ctx.tp``) ``h`` is the
    residual's sequence shard: the router runs on it, the experts (this
    rank's columns of ``d_ff_expert``) and shared experts on the whole
    sequence, and the partial outputs are reduce-scattered.  The
    auxiliary losses are this rank's shares of the global values (every
    rank holds the same number of tokens): the top-1 counts are summed
    over the ranks inside this call, and summed over the ranks the shares
    are the reference's means over all tokens.

    h [B, S, D].  Returns (out [B, S, D], {"moe_lb", "moe_z"} f32)."""
    e = cfg.moe
    b, s, d = h.shape
    act = activation_fn(cfg.activation)
    k, n_e = e.top_k, e.n_experts
    tp = getattr(ctx, "tp", False)
    if tp and ctx.rules.ffn is None:
        raise ValueError(f"{cfg.arch_id}: d_ff_expert {e.d_ff_expert} does "
                         f"not split over {ctx.model_size} model ranks")
    x = h.reshape(b * s, d)

    logits = (x @ p["router"]).float()                        # [T, E]
    probs = torch.softmax(logits, -1)
    gate_vals, idx = _top_k(probs, k)                         # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    xr, idx_r, gate_r = x, idx, gate_vals
    if tp:
        # the data shard's tokens, row-major, on every model rank
        mg = ctx.model_group
        xr = S.seq_gather(h, mg).reshape(-1, d)
        gate_r = S.seq_gather(gate_vals.reshape(b, s, k), mg).reshape(-1, k)
        idx_r = S.all_gather(idx.reshape(b, s, k), mg, dim=1).reshape(-1, k)
    n_tok = xr.shape[0]
    if e.expert_parallel and group is not None:
        whole = ctx is None or ctx.rules.experts is None
        out = _route_expert_parallel(p, xr, idx_r, gate_r, cfg, act, group,
                                     no_drop, whole)
    else:
        cap = n_tok if no_drop else max(
            1, int(n_tok * k / n_e * e.capacity_factor))
        out = _route_local(p, xr, idx_r, gate_r, cap, cfg, act)
    if e.n_shared_experts and "w_gate" in p:
        out = out + _mlp(p, xr, act)
    if tp:
        out = S.seq_scatter(out.reshape(b, -1, d), ctx.model_group)

    # aux losses: Switch-style load balance and the router z-loss
    lse2 = torch.logsumexp(logits, -1) ** 2
    top1 = F.one_hot(idx[:, 0], n_e)
    groups = [g for g in (group, ctx.model_group if tp else None)
              if g is not None]
    if not groups:
        me = probs.mean(0)
        ce = top1.float().mean(0)
        lb = n_e * torch.sum(me * ce) * e.load_balance_loss
        z = lse2.mean() * e.router_z_loss
    else:
        counts = top1.sum(0)
        n_glob = x.shape[0]
        for g in groups:
            dist.all_reduce(counts, group=g)
            n_glob *= dist.get_world_size(g)
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
    (see ``_ssd_chunked``).  On a grid (``ctx.tp``) ``h`` is the
    residual's sequence shard: the sequence is gathered over the model
    ranks, the whole mixer runs on every model rank (the reference keeps
    ``in_proj`` and ``out_proj`` replicated over ``"model"``) and this
    rank's shard of the output is returned."""
    tp = getattr(ctx, "tp", False)
    if tp:
        h = S.seq_gather(h, ctx.model_group)
    out = _ssd_mixer(p, h, batch, cfg, ctx, hook)
    return S.own_seq(out, ctx) if tp else out


def _ssd_mixer(p, h, batch, cfg, ctx, hook):
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
    ``_rglru_scan``).

    On a grid (``ctx.tp``) ``h`` is the residual's sequence shard and the
    sequence is gathered over the model ranks.  The recurrence is per
    channel, so where the ``ffn`` rule splits the width W (the
    reference's rules put ``w_x``, ``w_gate_br`` and the gates' columns
    and ``w_out``'s rows there) each rank runs W/M channels: its columns
    of ``w_x`` and ``w_gate_br``, its slice of the replicated ``conv_w``,
    ``conv_b`` and ``lru_a``; the gates read x over all W, gathered along
    the channels, against this rank's gate columns; and ``w_out``'s
    partial sums are reduce-scattered.  Otherwise the whole block runs on
    every model rank and this rank's shard of the output is returned."""
    tp = getattr(ctx, "tp", False)
    split = tp and ctx.rules.ffn is not None
    if tp:
        h = S.seq_gather(h, ctx.model_group)
    seg = batch["segment_ids"]
    first = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool),
                       seg[:, 1:] != seg[:, :-1]], dim=1)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if split:
        w_loc = (cfg.rglru.lru_width or cfg.d_model) // ctx.model_size
        cols = slice(S.model_rank(ctx) * w_loc,
                     (S.model_rank(ctx) + 1) * w_loc)
        conv_w, conv_b = conv_w[:, cols], conv_b[cols]
        p = dict(p, lru_a=p["lru_a"][cols])
    gate_br = F.gelu(h @ p["w_gate_br"], approximate="tanh")
    x = h @ p["w_x"]
    x, _ = _causal_conv(x, conv_w, conv_b, first=first)
    xg = S.seq_gather(x, ctx.model_group, dim=-1) if split else x
    y = _rglru_scan(p, x, first, ctx=ctx, hook=hook, xg=xg)
    y = y * gate_br
    out = y @ p["w_out"]
    if split:
        return S.seq_scatter(out, ctx.model_group)
    return S.own_seq(out, ctx) if tp else out


def _rglru_gates(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                 xg: Optional[torch.Tensor] = None):
    """The decay's log and the input gate from the gates' input ``xg``
    (default ``x``: every channel the gate weights' rows read)."""
    xg = x if xg is None else xg
    rg = torch.sigmoid(xg @ p["w_rec_gate"]).float()
    ig = torch.sigmoid(xg @ p["w_input_gate"]).float()
    log_a0 = F.logsigmoid(p["lru_a"].float())
    log_a = _LRU_C * rg * log_a0                       # [B,S,W] (<= 0)
    return log_a, ig


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) with ``jnp.clip``'s gradient: 1 inside, 1/2 at a bound
    (``torch.clamp`` would pass all of it), 0 outside."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _rglru_scan(p, x, first, ctx=None, hook=None, xg=None):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t x_t), a_t = 0 at document
    starts (the gates from ``xg``, default x); returns h in x's dtype.
    ``ctx.attn_impl == "pallas"`` with
    the channel and sequence lengths multiples of 128 (the reference's
    condition) runs the recurrence in the CUDA kernels (``lru_scan``),
    after calling ``hook``, if given, with its f32 arguments ``a`` and
    ``bterm``; every other case runs the plain forward under autograd
    (the reference's ``associative_scan`` route)."""
    log_a, ig = _rglru_gates(p, x, xg)
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
