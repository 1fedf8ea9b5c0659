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
