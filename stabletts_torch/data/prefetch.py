"""Asynchronous input pipeline: overlap host-side batch assembly (disk reads,
padding, phone-id conversion) and the host-to-device copy with the device
step. The port's copy of the JAX package's `data/prefetch.py`.

Replaces the reference's `DataLoader(num_workers=4, pin_memory=True,
persistent_workers=True)` (reference: train.py:55) with a thread pool: the
per-batch work is `np.load` and numpy copies (both release the GIL) and, in
the trainer's `fn`, a copy into pinned memory and a non-blocking copy to the
GPU, so loader threads overlap the step without process spawns or pickling.

Ordering is deterministic: batches are yielded in schedule order regardless
of which worker finishes first, and any randomness inside `fn` must be
seeded per item, so a prefetched run is bit-identical to a sequential one.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

from stabletts_torch.utils.metrics import span

T = TypeVar("T")
U = TypeVar("U")


def prefetch(
    items: Iterable[T],
    fn: Callable[[T], U],
    n_workers: int = 4,
    depth: int = 8,
) -> Iterator[U]:
    """Yield fn(item) for each item in order, computing up to `depth` items
    ahead on `n_workers` threads.

    A worker exception propagates at the yield position of its item (the
    remaining in-flight work is drained first so no thread outlives the
    generator). depth >= n_workers keeps every worker busy while the consumer
    holds the newest result. The consumer's wait for each item is the span
    "data.wait" (`utils.metrics`); the workers open none.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    it = iter(items)
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        futures: collections.deque = collections.deque()
        try:
            for item in it:
                futures.append(ex.submit(fn, item))
                if len(futures) >= depth:
                    break
            for item in it:
                with span("data.wait"):
                    out = futures.popleft().result()
                futures.append(ex.submit(fn, item))
                yield out
            while futures:
                with span("data.wait"):
                    out = futures.popleft().result()
                yield out
        finally:
            # generator closed early or an item raised: let queued work finish
            # (cancel what hasn't started) so no worker outlives this scope
            for f in futures:
                f.cancel()
