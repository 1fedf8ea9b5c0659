"""Step factories: the training and eval steps over packed batches, and
the serving step.  The port of ``repro.train.step``.

The reference jits pure functions of ``(params, opt_state, batch)``; here
the parameters live in the ``Transformer`` and the optimizer updates them
in place, so a train step maps ``(opt_state, batch)`` to
``(opt_state, metrics)``."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.train.loss import lm_loss

BATCH_KEYS = ("tokens", "labels", "segment_ids", "positions")


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The pipeline's host arrays as tensors on ``device`` (one copy per
    field), and the attached plan as int32 tensors (``plan.to``)."""
    out = {k: torch.as_tensor(np.asarray(batch[k]), device=device)
           for k in BATCH_KEYS if k in batch}
    if batch.get("plan") is not None:
        out["plan"] = batch["plan"].to(device)
    return out


def _bind(ctx, batch):
    if getattr(ctx, "cad", None) is not None and "plan" in batch:
        return ctx.cad.bind_plan(ctx, batch["plan"])
    return ctx


def make_train_step(model, ctx, optimizer, decay):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.
    ``decay`` flags the parameters that take weight decay
    (``models.convert.decay_mask``).
    ``batch`` is a pipeline batch (host arrays) that may carry a CAD plan
    under 'plan'; it is data, consumed by the dispatch through the ctx.
    The model's parameters are updated in place."""
    params = list(model.parameters())

    def train_step(opt_state, batch):
        b = batch_to_device(batch, model.device)
        logits, aux = model(b, _bind(ctx, b))
        loss, stats = lm_loss(logits, b["labels"], b["segment_ids"])
        del logits
        total = loss
        for v in aux.values():
            total = total + v
        grads = torch.autograd.grad(total, params)
        opt_state, gnorm = optimizer.update(grads, opt_state, params,
                                            decay)
        metrics = {"loss": loss.detach(), "total_loss": total.detach(),
                   "grad_norm": gnorm, "n_tokens": stats["n_tokens"]}
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
