"""Step factories: the training and eval steps over packed batches, and
the serving steps (ragged chunks, and the legacy dense decode step).
The port of ``repro.train.step``.

The reference jits pure functions of ``(params, opt_state, batch)``; here
the parameters live in the ``Transformer`` and the optimizer updates them
in place, so a train step maps ``(opt_state, batch)`` to
``(opt_state, metrics)``.

Under a CAD process group (``ctx.group``) each rank holds its rows of
the global batch: its loss is its own ``nll_sum`` over the global batch's
loss-token count (``batch["n_tokens_global"]``, known on every rank, no
collective), the gradients are summed across the ranks in flat buckets
(``allreduce_grads``) before the update, so every rank applies the same
update, and AdamW's clipping sees the global norm.  MoE's auxiliary
losses come out of the forward as this rank's shares of the global
values (``models.layers.moe_apply``), so the same all-reduce gives their
gradients; the metrics report them all-reduced.

On a ``("data", "model")`` grid (a model cut by
``convert.shard_model``) a rank's loss is the share of its sequence shard of its data rank's rows (``grid_nll_sum``), and a
gradient is summed over every grid axis its tensor is not split over
(``model.grid_placements``): over ``"data"`` as above, and over
``"model"`` for the tensors every model rank holds whole (norms, the
router, replicated projections), whose gradients each rank holds for its
own tokens or heads only.  The clip's norm counts each shard once
(``AdamW.update``'s ``norm_groups``)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel import sharded_over
from repro_torch.train.loss import grid_nll_sum, lm_loss

BATCH_KEYS = ("tokens", "labels", "segment_ids", "positions", "memory",
              "memory_mask")
# elements of one all-reduce bucket: bounds the flat copy of the grads
BUCKET_ELEMS = 1 << 26


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The pipeline's host arrays (and a cross-attention arch's
    ``memory`` [B, M, D] and ``memory_mask`` [B, M], host arrays or
    tensors) as tensors on ``device`` (one copy per field, none for a
    tensor already there), and the attached plan as int32 tensors
    (``plan.to``)."""
    out = {k: batch[k].to(device) if torch.is_tensor(batch[k])
           else torch.as_tensor(np.asarray(batch[k]), device=device)
           for k in BATCH_KEYS if batch.get(k) is not None}
    if batch.get("plan") is not None:
        out["plan"] = batch["plan"].to(device)
    return out


def _buckets(tensors):
    """Runs of consecutive same-dtype tensors of at most BUCKET_ELEMS
    elements (a larger tensor is a bucket of its own)."""
    run, n = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or n + t.numel() > BUCKET_ELEMS):
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


def _flat_collective(tensors, op) -> None:
    """Run ``op(flat)`` on each flat bucket of ``tensors`` and copy the
    result back in place."""
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        op(flat)
        off = 0
        for t in run:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def allreduce_grads(grads, group) -> None:
    """Sum ``grads`` across ``group`` in place, in flat buckets; every
    rank ends with the same bits."""
    _flat_collective(grads, lambda f: dist.all_reduce(f, group=group))


@torch.no_grad()
def broadcast_params(params, group, src: int = 0) -> None:
    """Every rank takes the parameters of ``group``'s rank ``src`` (flat
    buckets)."""
    src = dist.get_global_rank(group, src)
    _flat_collective(list(params),
                     lambda f: dist.broadcast(f, src=src, group=group))


def _bind(ctx, batch):
    if getattr(ctx, "cad", None) is not None and "plan" in batch:
        return ctx.cad.bind_plan(ctx, batch["plan"])
    return ctx


def grad_groups(model, ctx):
    """Per parameter: (the group its gradient is summed over, or None;
    the group its shards split over for the clip's norm, or None).
    Without a grid (no ``model.grid_placements``) every gradient is summed
    over the CAD group and no tensor is split."""
    if getattr(model, "grid_placements", None) is None:
        return [(getattr(ctx, "group", None), None)
                for _ in model.parameters()]
    by_axes = {(): None, ("data",): ctx.group, ("model",): ctx.model_group,
               ("data", "model"): dist.group.WORLD}
    out = []
    for name, _ in model.named_parameters():
        split = sharded_over(model.grid_placements[name])
        out.append((by_axes[tuple(a for a in ("data", "model")
                                  if a not in split)], by_axes[split]))
    return out


def _allreduce_by_group(grads, groups) -> None:
    """Sum each gradient over its group, one bucketed all-reduce per
    group in a fixed order (the same on every rank)."""
    order = []
    for grp in groups:
        if grp is not None and all(grp is not g for g in order):
            order.append(grp)
    for grp in order:
        allreduce_grads([g for g, gg in zip(grads, groups) if gg is grp],
                        grp)


def make_train_step(model, ctx, optimizer, decay):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.
    ``decay`` flags the parameters that take weight decay
    (``models.convert.decay_mask``).
    ``batch`` is a pipeline batch (host arrays) that may carry a CAD plan
    under 'plan'; it is data, consumed by the dispatch through the ctx.
    The model's parameters are updated in place."""
    params = list(model.parameters())
    group = getattr(ctx, "group", None)
    tp = getattr(ctx, "tp", False)
    grid = getattr(model, "grid_placements", None) is not None
    sums, norms = zip(*grad_groups(model, ctx))

    def train_step(opt_state, batch):
        b = batch_to_device(batch, model.device)
        logits, aux = model(b, _bind(ctx, b))
        if tp:
            nll = grid_nll_sum(logits, b["labels"], b["segment_ids"], ctx)
        else:
            loss, stats = lm_loss(logits, b["labels"], b["segment_ids"])
            nll, n_tokens = stats["nll_sum"], stats["n_tokens"]
        del logits
        if group is not None:
            # this rank's share of the global mean, divided as lm_loss
            # divides (by an integer tensor: a Python float divisor takes
            # CUDA's multiply-by-reciprocal path, other bits)
            n_tokens = torch.as_tensor(int(batch["n_tokens_global"]),
                                       device=model.device)
            loss = nll / n_tokens
        total = loss
        for v in aux.values():
            total = total + v
        grads = torch.autograd.grad(total, params)
        _allreduce_by_group(grads, sums)
        if group is not None:
            # the global loss and aux losses: each rank holds its share
            everyone = dist.group.WORLD if grid else group
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=everyone)
            aux = {k: v.detach().clone() for k, v in aux.items()}
            for v in aux.values():
                dist.all_reduce(v, group=everyone)
            total = loss
            for v in aux.values():
                total = total + v
        opt_state, gnorm = optimizer.update(grads, opt_state, params,
                                            decay, norm_groups=norms)
        metrics = {"loss": loss.detach(), "total_loss": total.detach(),
                   "grad_norm": gnorm, "n_tokens": n_tokens}
        metrics.update({k: v.detach() for k, v in aux.items()})
        return opt_state, metrics

    return train_step


def make_eval_step(model, ctx):
    """Returns ``eval_step(batch) -> {"loss", "n_tokens"}`` (no grad)."""
    def eval_step(batch):
        b = batch_to_device(batch, model.device)
        with torch.no_grad():
            logits, _ = model(b, _bind(ctx, b))
            loss, stats = lm_loss(logits, b["labels"], b["segment_ids"])
        return {"loss": loss, "n_tokens": stats["n_tokens"]}
    return eval_step


def make_serve_step(model, ctx=None):
    """One new token a row against a ``layout="decode"`` cache, the legacy
    dense decode path (the reference's ``make_serve_step``; the engine
    serves the cross-attention archs through it, and the dry run's
    ``decode_32k`` / ``long_500k`` shapes are this step on a grid).
    Returns ``serve_step(cache, tokens [B, 1], pos [B]) -> (next token [B]
    int32, logits [B, 1, V] f32)``; runs under ``torch.inference_mode``
    and updates the cache in place.  With ``ctx`` (a grid under
    ``parallel.decode_rules``) the model, cache, tokens and pos are this
    rank's (``Transformer.decode_step``)."""
    def serve_step(cache, tokens, pos):
        with torch.inference_mode():
            logits = model.decode_step(cache, tokens, pos, ctx)
            return logits[:, -1].argmax(-1).to(torch.int32), logits
    return serve_step


def make_serve_chunk_step(model):
    """Packed-prefill / ragged-decode serving step (DESIGN.md §8).

    One function serves both engine phases against a ``layout="serve"``
    cache: a fused chunked-prefill call (blk_q = 128 request-pure q blocks
    packed cu_seqlens-style into ``tokens [T]``) and a batched decode step
    (blk_q = 1, one token per request slot).  Runs under
    ``torch.inference_mode``; the cache is updated in place."""
    def chunk_step(cache, tokens, pos, block_req, kv_len_next):
        with torch.inference_mode():
            return model.serve_chunk_step(cache, tokens, pos, block_req,
                                          kv_len_next)
    return chunk_step
