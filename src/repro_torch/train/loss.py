"""Packed-LM loss: next-token cross-entropy within documents.

The port of ``repro.train.loss``."""
from __future__ import annotations

import torch


def lm_loss(logits, labels, segment_ids):
    """logits [B,S,V] f32, labels [B,S] (-1 = ignore), segment_ids [B,S].

    Loss counts position t iff label t is valid AND t is not padding.
    The data pipeline pre-shifts labels so labels[t] = tokens[t+1] within
    the same document and -1 at document tails/padding.
    """
    valid = (labels >= 0) & (segment_ids > 0)
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    n = valid.sum().clamp(min=1)
    return nll.sum() / n, {"n_tokens": n, "nll_sum": nll.sum()}


def grid_nll_sum(logits, labels, segment_ids, ctx):
    """On a grid (``ctx.tp``): the summed loss of this rank's tokens, its
    sequence shard of the data rank's rows, from ``Transformer.forward``'s
    logits.  Vocab-parallel logits ``[B, S, V/M]`` go through
    ``models.sharded.vocab_nll`` (each shard's max and sum of
    exponentials; the reference's ``vocab -> model`` rule), logits of a
    table the ``vocab`` rule leaves whole are this rank's ``[B, S/M, V]``
    already.  Summed over the grid's ranks the values are the whole
    batch's ``nll_sum``."""
    from repro_torch.models import sharded as S
    labels = labels.long()
    if ctx.rules.vocab is None:
        return lm_loss(logits, S.own_seq(labels, ctx),
                       S.own_seq(segment_ids, ctx))[1]["nll_sum"]
    b, s, v_loc = logits.shape
    valid = (labels >= 0) & (segment_ids > 0)
    safe = torch.where(valid, labels, 0)
    nll = S.vocab_nll(logits.reshape(b * s, v_loc), safe.reshape(-1),
                      S.model_rank(ctx) * v_loc, ctx.model_group)
    nll = nll.reshape(b, s) * valid
    return S.own_seq(nll, ctx).sum()
