"""Synthetic document-length distributions (paper §6.1 "Input data").

The port's copy of ``repro.data.distributions`` (numpy only).

"Pretrain": a pretraining-style power-law length distribution with long
documents upsampled by filtering out documents shorter than a threshold
(Fu et al., 2024), exactly as the paper describes.

"ProLong": a long-context-specialized mixture with a higher fraction of
long documents (Gao et al., 2025 train on mixtures where long documents
carry a large token share).
"""
from __future__ import annotations

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


DISTRIBUTIONS = {"pretrain": pretrain_lengths, "prolong": prolong_lengths}


def sample_lengths(name: str, rng: np.random.Generator, n: int,
                   max_len: int) -> np.ndarray:
    if name == "pretrain":
        return pretrain_lengths(rng, n, max_len,
                                upsample_threshold=max_len // 8)
    if name == "prolong":
        return prolong_lengths(rng, n, max_len)
    raise KeyError(name)
