"""Document packing into fixed-size chunks (paper §1 / §3.1).

The port's copy of ``repro.data.packing`` (numpy only).  ``BLOCK`` is
also the serving slice's 128-token alignment: every prefill piece is
aligned to it so q blocks stay request-pure, and the serving cache
length is padded to it.

Packing strategies:

  fixed_packing        — greedy first-fit into equal-token chunks (the
                         memory-balanced, compute-imbalanced baseline)
  variable_packing     — WLB-LLM-style variable-length chunking: documents
                         are redistributed so per-chunk Σl² (attention
                         FLOPs) is approximately equal, at the price of
                         unequal token counts / activation memory (§3.2)

Both align every document to BLOCK (=128) tokens with segment-0 padding so
q/kv blocks are document-pure — the invariant the CAD scheduler, plan
builder, and kernels rely on (the paper's kernels have the same 128-token
tile constraint, Fig. 5).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

BLOCK = 128


@dataclasses.dataclass
class PackedChunk:
    """One rank's chunk: token ids / segment ids / in-doc positions."""
    tokens: np.ndarray        # [L] int32
    segment_ids: np.ndarray   # [L] int32 (0 = padding)
    positions: np.ndarray     # [L] int32
    doc_lengths: List[int]    # true (unpadded) lengths


def _aligned(l: int, block: int = BLOCK) -> int:
    return ((l + block - 1) // block) * block


def pack_documents(doc_lengths: Sequence[int], chunk_tokens: int,
                   n_chunks: int, *, block: int = BLOCK,
                   rng: Optional[np.random.Generator] = None,
                   strategy: str = "fixed",
                   vocab_size: int = 32000) -> List[PackedChunk]:
    """Pack documents into exactly ``n_chunks`` chunks of ``chunk_tokens``.

    Documents that don't fit are split at block boundaries (the paper's
    sequential placement: "If a device reaches its token threshold before
    a document is fully placed, the remaining portion is put to the next
    device" — we instead truncate-to-fit per chunk and continue the doc as
    a fresh segment, keeping the no-doc-spans-ranks invariant that makes
    the identity plan communication-free; the CAD scheduler re-balances
    across ranks anyway, which is the paper's whole point)."""
    assert chunk_tokens % block == 0
    rng = rng or np.random.default_rng(0)
    if strategy == "fixed":
        order = list(range(len(doc_lengths)))
    elif strategy == "variable":
        order = list(np.argsort(doc_lengths)[::-1])   # longest-first
    else:
        raise KeyError(strategy)

    chunks = [{"docs": [], "used": 0, "cost": 0.0} for _ in range(n_chunks)]

    def fit(c, l):
        return c["used"] + _aligned(l, block) <= chunk_tokens

    for di in order:
        l = int(doc_lengths[di])
        while l > 0:
            if strategy == "variable":
                # least-attention-cost chunk with room (WLB-style Σl² balance)
                cands = [c for c in chunks if c["used"] < chunk_tokens]
                cands.sort(key=lambda c: c["cost"])
            else:
                cands = [c for c in chunks if fit(c, min(l, block))]
            placed = False
            for c in cands:
                room = chunk_tokens - c["used"]
                if room < block:
                    continue
                take = min(_aligned(l, block), room)
                take_real = min(l, take)
                c["docs"].append(take_real)
                c["used"] += _aligned(take_real, block)
                c["cost"] += float(take_real) ** 2
                l -= take_real
                placed = True
                break
            if not placed:
                break  # batch full; drop remainder (sampler oversamples)

    out = []
    seg_counter = 1
    for c in chunks:
        tokens = np.zeros(chunk_tokens, np.int32)
        seg = np.zeros(chunk_tokens, np.int32)
        pos = np.zeros(chunk_tokens, np.int32)
        t = 0
        for dl in c["docs"]:
            al = _aligned(dl, block)
            tokens[t:t + dl] = rng.integers(1, vocab_size,
                                            dl).astype(np.int32)
            seg[t:t + dl] = seg_counter
            pos[t:t + dl] = np.arange(dl)
            seg_counter += 1
            t += al
        out.append(PackedChunk(tokens=tokens, segment_ids=seg,
                               positions=pos, doc_lengths=list(c["docs"])))
    return out


def chunk_attention_cost(chunk: PackedChunk) -> float:
    """Σ l² over documents — the quadratic CA term of §3.1."""
    return float(sum(l * l for l in chunk.doc_lengths))


def chunk_tokens_used(chunk: PackedChunk) -> int:
    return int((chunk.segment_ids > 0).sum())
