"""Step factories.  This slice ports the serving one only; the training
step comes with the CAD training slice."""
from __future__ import annotations

import torch


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
