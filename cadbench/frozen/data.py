"""Frozen copy of the port's traffic generator: ``data/distributions.py``,
``data/packing.py`` and ``raw_batches`` with its labels from
``data/pipeline.py`` (numpy only).  The same ``TrafficConfig`` and seed
give the batches the port's ``raw_batches`` gives for the
``PipelineConfig`` with the same fields.

Distributions (paper section 6.1): "pretrain" is a power law with long
documents upsampled; "prolong" is 60% short (power law up to 8K) and 40%
long (log-uniform in [max/16, max]).  Packing is greedy first-fit into
equal-token rows, every document aligned to BLOCK tokens with segment-0
padding, a document that does not fit continued as a fresh segment in
the next row.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np


def pretrain_lengths(rng: np.random.Generator, n: int, max_len: int,
                     min_len: int = 128, alpha: float = 1.3,
                     upsample_threshold: int = 0,
                     upsample_drop: float = 0.7) -> np.ndarray:
    """Power-law lengths in [min_len, max_len]; optionally upsample long
    docs by dropping a fraction of docs below ``upsample_threshold``."""
    u = rng.random(n)
    lo, hi = float(min_len), float(max_len)
    # inverse-CDF of p(l) ~ l^-alpha on [lo, hi]
    a1 = 1.0 - alpha
    ls = ((lo ** a1) + u * ((hi ** a1) - (lo ** a1))) ** (1.0 / a1)
    ls = np.clip(ls, lo, hi).astype(np.int64)
    if upsample_threshold:
        keep = (ls >= upsample_threshold) | \
            (rng.random(n) > upsample_drop)
        ls = ls[keep]
    return ls


def prolong_lengths(rng: np.random.Generator, n: int,
                    max_len: int) -> np.ndarray:
    """Mixture: 60% short (power law up to 8K), 40% long
    (log-uniform in [max/16, max])."""
    n_long = int(n * 0.4)
    short = pretrain_lengths(rng, n - n_long, min(8192, max_len))
    lo, hi = np.log(max(max_len // 16, 256)), np.log(max_len)
    long_ = np.exp(rng.random(n_long) * (hi - lo) + lo).astype(np.int64)
    ls = np.concatenate([short, np.clip(long_, 256, max_len)])
    rng.shuffle(ls)
    return ls



def sample_lengths(name: str, rng: np.random.Generator, n: int,
                   max_len: int) -> np.ndarray:
    if name == "pretrain":
        return pretrain_lengths(rng, n, max_len,
                                upsample_threshold=max_len // 8)
    if name == "prolong":
        return prolong_lengths(rng, n, max_len)
    raise KeyError(name)


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


@dataclasses.dataclass
class TrafficConfig:
    distribution: str = "pretrain"     # pretrain | prolong
    max_doc_len: int = 4096
    seq_len: int = 4096                # tokens per row
    global_batch: int = 8              # rows per step
    vocab_size: int = 32000
    seed: int = 0
    strategy: str = "fixed"            # fixed | variable


def labels_of(tokens, seg):
    """Next-token labels within a document, -1 at document tails and on
    padding."""
    nxt = np.roll(tokens, -1, axis=-1)
    nseg = np.roll(seg, -1, axis=-1)
    lab = np.where((seg > 0) & (seg == nseg), nxt, -1)
    return lab.astype(np.int32)


def raw_batches(cfg: TrafficConfig) -> Iterator[dict]:
    """Packed batches: tokens, labels, segment_ids, positions [rows, seq]
    as host numpy arrays."""
    rng = np.random.default_rng(cfg.seed)
    while True:
        need = cfg.global_batch * cfg.seq_len
        lens = []
        while sum(lens) < need * 1.2:
            lens.extend(sample_lengths(cfg.distribution, rng, 64,
                                       cfg.max_doc_len).tolist())
        chunks = pack_documents(lens, cfg.seq_len, cfg.global_batch,
                                rng=rng, strategy=cfg.strategy,
                                vocab_size=cfg.vocab_size)
        toks = np.stack([c.tokens for c in chunks])
        segs = np.stack([c.segment_ids for c in chunks])
        poss = np.stack([c.positions for c in chunks])
        yield {"tokens": toks, "labels": labels_of(toks, segs),
               "segment_ids": segs, "positions": poss}


def segment_lengths(segment_ids) -> List[int]:
    """The length of every packed segment (a document, or the part of one
    that a row holds), row by row, padding left out."""
    out = []
    for row in np.asarray(segment_ids):
        ids, counts = np.unique(row[row > 0], return_counts=True)
        out.extend(int(c) for c in counts)
    return out
