"""Training dataset: JSONL filelist of precomputed mels + phoneme strings
(reference: datas/dataset.py:19-69), producing static-shape padded batches.

The port's copy of the JAX package's `data/dataset.py`. Differences from the
reference:
  * mels are stored as .npy [T, n_mels] (channels-last) instead of torch .pt
  * batches are padded to the bucket's static shape instead of max-in-batch
    dynamic padding
  * the random reference-mel slice (overfitting guard, dataset.py:63-69) is
    seeded per (epoch, index) for reproducibility across hosts
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from stabletts_torch.text import cleaned_text_to_sequence, intersperse


@dataclass
class Batch:
    """Host-side numpy batch with static shapes."""

    x: np.ndarray  # [B, Tx] int32 phoneme ids
    x_lengths: np.ndarray  # [B] int32
    y: np.ndarray  # [B, Ty, n_mels] f32
    y_lengths: np.ndarray  # [B] int32
    z: np.ndarray  # [B, Tz, n_mels] f32 sliced reference mel
    z_lengths: np.ndarray  # [B] int32

    def as_tuple(self):
        return (self.x, self.x_lengths, self.y, self.y_lengths, self.z, self.z_lengths)


class StableDataset:
    """Loads the JSONL filelist; items are (mel [T, n_mels], phone ids)."""

    def __init__(self, filelist_path: str):
        self.filelist: List[Tuple[str, list]] = []
        self.lengths: List[int] = []
        with open(filelist_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                self.filelist.append((rec["mel_path"], rec["phone"]))
                self.lengths.append(int(rec["mel_length"]))

    def __len__(self):
        return len(self.filelist)

    def load_mel(self, idx: int) -> np.ndarray:
        mel_path, _ = self.filelist[idx]
        mel = np.load(mel_path)
        if mel.ndim != 2:
            raise ValueError(f"bad mel shape {mel.shape} at {mel_path}")
        return mel.astype(np.float32)

    def phone_ids(self, idx: int) -> np.ndarray:
        _, phone = self.filelist[idx]
        ids = intersperse(cleaned_text_to_sequence(phone), 0)
        return np.asarray(ids, dtype=np.int32)


def random_slice(mel: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random [T/12, T/3] slice for the reference encoder
    (reference: datas/dataset.py:63-69)."""
    length = mel.shape[0]
    if length < 12:
        return mel
    seg = int(rng.integers(length // 12, length // 3 + 1))
    start = int(rng.integers(0, length - seg + 1))
    return mel[start : start + seg]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def collate(
    dataset: StableDataset,
    indices: Sequence[int],
    pad_mel_to: int,
    pad_text_to: int,
    n_mels: int,
    rng,
) -> Batch:
    """Pad a batch of items to the static (pad_text_to, pad_mel_to) shape.

    rng is either a np.random.Generator (z-slices drawn sequentially — batch
    randomness then depends on iteration order) or a seed-prefix sequence of
    ints: each item's slice PRNG becomes default_rng(SeedSequence([*prefix,
    item_idx])), which makes the assembled global batch independent of rank
    count, loader-worker scheduling, and batch order — required for
    1-process vs N-process training equality (tests/test_multiprocess.py).
    """
    b = len(indices)
    # slices are at most T/3 long, so the z buffer's shape is static per bucket
    z_len = _round_up(max(pad_mel_to // 3, 12), 64)
    x = np.zeros((b, pad_text_to), dtype=np.int32)
    xl = np.zeros((b,), dtype=np.int32)
    y = np.zeros((b, pad_mel_to, n_mels), dtype=np.float32)
    yl = np.zeros((b,), dtype=np.int32)
    z = np.zeros((b, z_len, n_mels), dtype=np.float32)
    zl = np.zeros((b,), dtype=np.int32)
    seq_rng = rng if isinstance(rng, np.random.Generator) else None
    for i, idx in enumerate(indices):
        mel = dataset.load_mel(idx)
        ids = dataset.phone_ids(idx)
        t_mel = min(mel.shape[0], pad_mel_to)
        t_txt = min(len(ids), pad_text_to)
        y[i, :t_mel] = mel[:t_mel]
        yl[i] = t_mel
        x[i, :t_txt] = ids[:t_txt]
        xl[i] = t_txt
        item_rng = seq_rng if seq_rng is not None else np.random.default_rng(
            np.random.SeedSequence([*rng, int(idx)])
        )
        sl = random_slice(mel[:t_mel], item_rng)
        t_sl = min(sl.shape[0], z_len)
        z[i, :t_sl] = sl[:t_sl]
        zl[i] = t_sl
    return Batch(x, xl, y, yl, z, zl)
