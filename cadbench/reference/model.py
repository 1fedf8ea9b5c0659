"""The plain reference of a cell's training step: a Llama-style decoder
(RMSNorm, rotary positions on split halves, grouped-query causal
attention within each packed document, SwiGLU MLP, output head tied or
not), next-token cross-entropy within documents averaged over the
batch's loss tokens, the gradient, and AdamW with a global-norm clip, all
in float32 with TF32 off, written from the published Llama description.

It follows the configuration's stated arithmetic where the description
leaves a choice: RMSNorm's epsilon ``norm_eps``; rotary frequencies
theta**(-i/half) on the two halves of a head; the softmax scale
head_dim**-0.5; query head h reads kv head h // (n_heads / n_kv_heads);
weight decay on every matrix and on every per-layer vector (the decay
rule of the training recipe); bias correction with eps outside the
square root.

To fit the card at the timed sizes it runs a batch a row at a time (no
document spans two rows), each layer under ``torch.utils.checkpoint``,
and attention a block of queries at a time with a recomputing backward.

``precision="fp8"`` is the control: every matrix product's operands
(the projections, the MLP, q, k and v, the output head) rounded to
float8 e4m3 with a per-tensor scale in the forward pass, the gradient
passed straight through.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .weights import make_weights, param_specs

FP8_MAX = 448.0
# elements of one block of attention logits (f32): bounds the query block
ATTN_BLOCK_ELEMS = 1 << 27


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _RoundFP8(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale, in f32, with the
    gradient passed straight through; one f32 temporary besides the
    result, so the control fits where the f32 reference does."""

    @staticmethod
    def forward(ctx, x):
        lo, hi = torch.aminmax(x)
        s = FP8_MAX / torch.maximum(hi, -lo).clamp(min=1e-30)
        return (x * s).to(torch.float8_e4m3fn).float().div_(s)

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def __call__(self, x):
        return _RoundFP8.apply(x) if self.kind == "fp8" else x


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x [S, H, dh], pos [S] in-document positions."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _block(hq: int, length: int) -> int:
    c = ATTN_BLOCK_ELEMS // max(1, hq * length)
    return max(16, min(length, c // 16 * 16 or 16))


def _mask_diagonal(s, a: int, b: int) -> None:
    """Mask, in place, the keys after each query of the block of queries
    a..b-1 (the keys a..b-1 are the only ones a query there may not see)."""
    future = torch.ones((b - a, b - a), dtype=torch.bool,
                        device=s.device).triu_(1)
    s[..., a:b].masked_fill_(future, float("-inf"))


class DocAttention(torch.autograd.Function):
    """Causal attention within each document of one row.  q [S, Hq, dh],
    k/v [S, Hkv, dh] f32; ``docs`` [(start, length)]; rows outside every
    document (padding) give 0."""

    @staticmethod
    def forward(ctx, q, k, v, docs):
        S, hq, dh = q.shape
        hkv = k.shape[1]
        rep = hq // hkv
        scale = dh ** -0.5
        out = torch.zeros_like(q)
        lse = torch.zeros((hq, S), dtype=q.dtype, device=q.device)
        for s0, L in docs:
            qd = q[s0:s0 + L].permute(1, 0, 2).reshape(hkv, rep, L, dh)
            kd = k[s0:s0 + L].permute(1, 0, 2)[:, None]       # [hkv,1,L,dh]
            vd = v[s0:s0 + L].permute(1, 0, 2)[:, None]
            c = _block(hq, L)
            for a in range(0, L, c):
                b = min(L, a + c)
                s = (qd[:, :, a:b] @ kd[:, :, :b].transpose(-1, -2)).mul_(
                    scale)
                _mask_diagonal(s, a, b)
                m = s.amax(-1, keepdim=True)
                p = s.sub_(m).exp_()
                l_ = p.sum(-1, keepdim=True)
                o = (p @ vd[:, :, :b]).div_(l_)               # [hkv,rep,c,dh]
                out[s0 + a:s0 + b] = o.reshape(hq, b - a, dh).permute(1, 0, 2)
                lse[:, s0 + a:s0 + b] = m.add_(l_.log_()).reshape(hq, b - a)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.docs = docs
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        S, hq, dh = q.shape
        hkv = k.shape[1]
        rep = hq // hkv
        scale = dh ** -0.5
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        for s0, L in ctx.docs:
            sl = slice(s0, s0 + L)
            qd = q[sl].permute(1, 0, 2).reshape(hkv, rep, L, dh)
            od = out[sl].permute(1, 0, 2).reshape(hkv, rep, L, dh)
            gd = dout[sl].permute(1, 0, 2).reshape(hkv, rep, L, dh)
            ld = lse[:, sl].reshape(hkv, rep, L, 1)
            kd = k[sl].permute(1, 0, 2)[:, None]
            vd = v[sl].permute(1, 0, 2)[:, None]
            dkd = torch.zeros((hkv, L, dh), dtype=q.dtype, device=q.device)
            dvd = torch.zeros_like(dkd)
            delta = (gd * od).sum(-1, keepdim=True)
            c = _block(hq, L)
            for a in range(0, L, c):
                b = min(L, a + c)
                s = (qd[:, :, a:b] @ kd[:, :, :b].transpose(-1, -2)).mul_(
                    scale)
                _mask_diagonal(s, a, b)
                p = s.sub_(ld[:, :, a:b]).exp_()
                g = gd[:, :, a:b]
                dvd[:, :b] += (p.transpose(-1, -2) @ g).sum(1)
                ds = (g @ vd[:, :, :b].transpose(-1, -2)).sub_(
                    delta[:, :, a:b]).mul_(p).mul_(scale)
                dqc = ds @ kd[:, :, :b]                        # [hkv,rep,c,dh]
                dq[s0 + a:s0 + b] = dqc.reshape(hq, b - a, dh).permute(1, 0, 2)
                dkd[:, :b] += (ds.transpose(-1, -2) @ qd[:, :, a:b]).sum(1)
            dk[sl] = dkd.permute(1, 0, 2)
            dv[sl] = dvd.permute(1, 0, 2)
        return dq, dk, dv, None


def documents(seg_row, pos_row) -> List[tuple]:
    """(start, length) of each packed segment of a row; checks that each is
    contiguous with positions 0..L-1."""
    seg = np.asarray(seg_row)
    pos = np.asarray(pos_row)
    docs = []
    for sid in np.unique(seg[seg > 0]):
        idx = np.nonzero(seg == sid)[0]
        s0, L = int(idx[0]), len(idx)
        if idx[-1] - s0 + 1 != L or not (pos[idx] == np.arange(L)).all():
            raise ValueError(f"segment {sid} is not one run of positions "
                             f"0..{L - 1}")
        docs.append((s0, L))
    return docs


def _layer(h, p, shape, pos, docs, prec):
    S = h.shape[0]
    hq, hkv, dh = shape["n_heads"], shape["n_kv_heads"], shape["head_dim"]
    eps = shape["norm_eps"]
    x = prec(rms_norm(h, p["norm1.scale"], eps))
    q = (x @ prec(p["attn.wq"])).view(S, hq, dh)
    k = (x @ prec(p["attn.wk"])).view(S, hkv, dh)
    v = (x @ prec(p["attn.wv"])).view(S, hkv, dh)
    q = rope(q, pos, shape["rope_theta"])
    k = rope(k, pos, shape["rope_theta"])
    a = DocAttention.apply(prec(q), prec(k), prec(v), docs)
    h = h + prec(a.reshape(S, hq * dh)) @ prec(p["attn.wo"])
    x = prec(rms_norm(h, p["norm2.scale"], eps))
    inner = F.silu(x @ prec(p["ffn.w_gate"])) * (x @ prec(p["ffn.w_up"]))
    return h + prec(inner) @ prec(p["ffn.w_down"])


def row_nll(params, shape, tokens, labels, seg, pos, docs, prec):
    """The summed next-token loss of one row [S]."""
    h = F.embedding(tokens.long(), params["embed"])
    for i in range(shape["n_layers"]):
        pre = f"layers.{i}."
        p = {n[len(pre):]: t for n, t in params.items() if n.startswith(pre)}
        h = checkpoint(_layer, h, p, shape, pos, docs, prec,
                       use_reentrant=False)
    h = rms_norm(h, params["final_norm.scale"], shape["norm_eps"])
    table = params["embed" if shape["tie_embeddings"] else "unembed"]
    logits = prec(h) @ prec(table).T
    valid = (labels >= 0) & (seg > 0)
    gold = logits.gather(-1, torch.where(valid, labels, 0).long()[:, None])
    nll = (torch.logsumexp(logits, -1) - gold[:, 0]) * valid
    return nll.sum()


def decays(name: str, t: torch.Tensor) -> bool:
    """The recipe's decay rule: every per-layer tensor, and a top-level
    one with two or more dims."""
    return t.dim() >= (1 if name.startswith("layers.") else 2)


def lr_at(step: int, train: Dict) -> float:
    """Linear warm-up to ``peak_lr`` then cosine decay to a tenth of it over
    ``steps`` (step counted from 1)."""
    peak, warm, total = train["peak_lr"], train["warmup"], train["steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def train_steps(shape: Dict, seed: int, batches: Sequence[Dict],
                train: Dict, device, precision: str = "f32",
                rows: Optional[int] = None, stored=torch.bfloat16,
                on_first_grad=None) -> Dict:
    """Run ``len(batches)`` AdamW steps from the seed's weights; returns the
    loss of each step, the first step's global gradient norm and its
    per-tensor norms (before the clip), and the per-tensor norms of the
    parameters' change, as the stored dtype keeps them after the last
    step.  ``rows`` keeps the first ``rows`` rows of each batch only (a
    fault: part of the batch left out, the mean taken over the rest).
    ``on_first_grad`` is called with the first step's gradients (by name,
    f32, before the clip) while they are alive."""
    no_tf32()
    prec = Precision(precision)
    init = make_weights(shape, seed, device, stored)
    names = [n for n, _, _ in param_specs(shape)]
    params = {n: init[n].float().requires_grad_() for n in names}
    mu = {n: torch.zeros_like(params[n]) for n in names}
    nu = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps, clip = 0.9, 0.95, 1e-8, 1.0
    wd = train["weight_decay"]
    losses, first = [], None
    for step, batch in enumerate(batches, 1):
        r = rows or batch["tokens"].shape[0]
        valid = ((batch["labels"][:r] >= 0)
                 & (batch["segment_ids"][:r] > 0)).sum()
        n_valid = max(1, int(valid))
        for n in names:
            params[n].grad = None
        total = 0.0
        for i in range(r):
            t = {k: torch.as_tensor(np.asarray(batch[k][i]), device=device)
                 for k in ("tokens", "labels", "segment_ids", "positions")}
            docs = documents(batch["segment_ids"][i], batch["positions"][i])
            nll = row_nll(params, shape, t["tokens"], t["labels"],
                          t["segment_ids"], t["positions"], docs, prec)
            (nll / n_valid).backward()
            total += float(nll.detach())
        losses.append(total / n_valid)
        with torch.no_grad():
            grads = {n: params[n].grad for n in names}
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if first is None:
                first = {"grad_norm": float(gnorm),
                         "grad_norms": {n: float(g.norm())
                                        for n, g in grads.items()}}
                if on_first_grad is not None:
                    on_first_grad(grads)
            scale = min(1.0, clip / (float(gnorm) + 1e-9))
            lr = lr_at(step, train)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for n in names:
                p, g = params[n], grads[n] * scale
                mu[n].mul_(b1).add_((1 - b1) * g)
                nu[n].mul_(b2).add_((1 - b2) * g * g)
                delta = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + eps)
                if decays(n, p):
                    delta = delta + wd * p
                p.sub_(lr * delta)
    with torch.no_grad():
        change = {n: float((params[n].to(stored).float()
                            - init[n].float()).norm()) for n in names}
    return {"losses": losses, "change_norms": change, **first}
