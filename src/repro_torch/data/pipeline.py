"""Training data pipeline: samples a length distribution, packs documents
into per-rank chunks, and emits host numpy batches (+ labels with
in-document next-token shift).

The port's copy of ``repro.data.pipeline``: the same seed gives the same
arrays.  The train step moves them to the device once per step.

Plan attachment is the :class:`repro_torch.cad.CADSession`'s job
(``session.attach_plans(raw_batches(cfg))`` — asynchronous, prefetched).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core.mask import validate_mask_layout
from repro_torch.data.distributions import sample_lengths
from repro_torch.data.packing import BLOCK, pack_documents


@dataclasses.dataclass
class PipelineConfig:
    distribution: str = "pretrain"     # pretrain | prolong
    max_doc_len: int = 4096
    seq_len: int = 4096                # tokens per row
    global_batch: int = 8              # rows per step
    n_ranks: int = 1                   # data-parallel ranks (CAD servers)
    vocab_size: int = 32000
    seed: int = 0
    strategy: str = "fixed"            # fixed | variable (WLB baseline)


def _labels(tokens, seg):
    nxt = np.roll(tokens, -1, axis=-1)
    nseg = np.roll(seg, -1, axis=-1)
    lab = np.where((seg > 0) & (seg == nseg), nxt, -1)
    return lab.astype(np.int32)


def raw_batches(cfg: PipelineConfig) -> Iterator[dict]:
    """Packed batches without plans — feed through
    ``CADSession.attach_plans`` when CAD is on.

    Fields are host numpy arrays: the plan prefetcher reads
    ``segment_ids`` on its worker thread without touching the device,
    and the train step moves everything to the device once."""
    rng = np.random.default_rng(cfg.seed)
    while True:
        # oversample docs, pack exactly global_batch rows
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
        # packed doc boundaries feed the segment mask downstream; a
        # layout violating the doc-pure-block invariant (overlapping or
        # misaligned segments) must fail here, named, not as silent
        # cross-document attention in a fused batch (DESIGN.md §12)
        validate_mask_layout(None, segs, BLOCK)
        yield {
            "tokens": toks,
            "labels": _labels(toks, segs),
            "segment_ids": segs,
            "positions": poss,
        }


ROW_KEYS = ("tokens", "labels", "segment_ids", "positions")


def rank_rows(batch: dict, rank: int, n_ranks: int) -> dict:
    """Rank ``rank``'s rows of a global batch (rank-major: rank r owns
    rows ``[r·rpr, (r+1)·rpr)``, rpr = rows / ``n_ranks``); fields other
    than the row arrays are left out."""
    rows = np.asarray(batch["tokens"]).shape[0]
    if rows % n_ranks:
        raise ValueError(f"{rows} rows do not split over {n_ranks} ranks")
    rpr = rows // n_ranks
    return {k: np.asarray(batch[k])[rank * rpr:(rank + 1) * rpr]
            for k in ROW_KEYS if k in batch}


def global_token_count(batch: dict) -> int:
    """The loss tokens of a whole batch (labels >= 0 on live segments, at
    least 1): the divisor of every rank's share of the loss, known on
    every rank from the global batch without a collective."""
    lab = np.asarray(batch["labels"])
    seg = np.asarray(batch["segment_ids"])
    return max(1, int(((lab >= 0) & (seg > 0)).sum()))
