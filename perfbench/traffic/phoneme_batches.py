"""Closed-loop batch job of phoneme-id items: the text lengths of a pool of
`pool_batches` x `batch` items are the log-normal's quantiles (the same set
for every seed), shuffled by the seed into batches in arrival order; the ids
are random phonemes with the blank id 0 between them, as the text front end
intersperses it. The job cycles over the pool."""

from __future__ import annotations

from statistics import NormalDist

import numpy as np


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """n lengths at the (i + 0.5) / n quantiles, rounded and clipped."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def generate(params: dict, seed: int, n_vocab: int) -> list:
    """[{"ids": int64 [B, Tx], "x_lengths": int64 [B]}] for each batch of the pool."""
    rng = np.random.default_rng(seed)
    b, pool = params["batch"], params["pool_batches"]
    t = params["text_ids"]
    lengths = lognormal_quantiles(b * pool, t["median"], t["sigma"], t["min"], t["max"])
    lengths = lengths - (lengths % 2 == 0)          # 2 x phonemes + 1
    rng.shuffle(lengths)
    batches = []
    for i in range(pool):
        ls = lengths[i * b:(i + 1) * b]
        ids = np.zeros((b, int(ls.max())), dtype=np.int64)
        for j, n in enumerate(ls):
            ids[j, 1:n:2] = rng.integers(1, n_vocab, size=n // 2)
        batches.append({"ids": ids, "x_lengths": ls.copy()})
    return batches
