"""Distributed bucket sampler (reference: datas/sampler.py:4-132).

Groups utterances into mel-length buckets, pads each bucket to a multiple of
(num_replicas * batch_size) by repeating indices, rank-strides the result, and
shuffles deterministically by epoch seed — so every host computes the same
global assignment independently (the reference's DistributedBucketSampler
semantics, with numpy RNG instead of torch.Generator).

Each emitted batch carries its bucket id so the collate layer pads to that
bucket's static shape. The port's copy of the JAX package's `data/sampler.py`.
"""

from __future__ import annotations

import bisect
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class DistributedBucketSampler:
    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        boundaries: Sequence[int],
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
    ):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.epoch = 0

        self.buckets = self._create_buckets()
        self.num_samples_per_bucket = []
        total = self.num_replicas * self.batch_size
        for bucket in self.buckets:
            rem = (total - (len(bucket) % total)) % total
            self.num_samples_per_bucket.append(len(bucket) + rem)
        self.total_size = sum(self.num_samples_per_bucket)
        self.num_samples = self.total_size // self.num_replicas

    def _bisect(self, length: int) -> int:
        """Bucket index for a length, or -1 if outside all boundaries
        (out-of-range samples are dropped, reference: datas/sampler.py:10-11)."""
        # bucket k holds boundaries[k] < length <= boundaries[k+1]
        i = bisect.bisect_left(self.boundaries, length)
        if i == 0 or i == len(self.boundaries):
            return -1  # length <= boundaries[0] or length > boundaries[-1]
        return i - 1

    def _create_buckets(self) -> List[List[int]]:
        buckets: List[List[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for idx, length in enumerate(self.lengths):
            b = self._bisect(length)
            if b != -1:
                buckets[b].append(idx)
        # drop empty tail buckets (small-dataset fallback, sampler.py:40-55)
        for i in range(len(buckets) - 1, -1, -1):
            if len(buckets[i]) == 0:
                buckets.pop(i)
                self.boundaries.pop(i + 1)
        assert all(buckets), "empty bucket survived"
        return buckets

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def bucket_mel_len(self, bucket_idx: int) -> int:
        """Static pad length for a bucket = its upper boundary."""
        return self.boundaries[bucket_idx + 1]

    def __iter__(self) -> Iterator[Tuple[int, List[int]]]:
        """Yields (bucket_idx, item_indices) batches."""
        g = np.random.default_rng(self.epoch)
        if self.shuffle:
            orders = [g.permutation(len(b)).tolist() for b in self.buckets]
        else:
            orders = [list(range(len(b))) for b in self.buckets]

        batches = []
        for i, bucket in enumerate(self.buckets):
            ids = orders[i]
            n_bucket = len(bucket)
            rem = self.num_samples_per_bucket[i] - n_bucket
            ids = ids + ids * (rem // n_bucket) + ids[: rem % n_bucket]
            ids = ids[self.rank :: self.num_replicas]
            for j in range(len(ids) // self.batch_size):
                chunk = ids[j * self.batch_size : (j + 1) * self.batch_size]
                batches.append((i, [bucket[k] for k in chunk]))

        if self.shuffle:
            order = g.permutation(len(batches))
            batches = [batches[k] for k in order]
        assert len(batches) * self.batch_size == self.num_samples
        return iter(batches)

    def __len__(self) -> int:
        return self.num_samples // self.batch_size
