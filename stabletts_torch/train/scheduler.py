"""Learning-rate schedules: transformers-style cosine with linear warmup
(reference: utils/scheduler.py:96-124, train.py:61), which both trainers use,
and the other schedules of the JAX package's `train/scheduler.py` (constant,
linear, inverse-sqrt, cosine with hard restarts, polynomial and
warmup-stable-decay), which, as there, no trainer wires in.

Each schedule here is the multiplier of the base rate at update `step`
(0-based), the JAX package's schedule divided by its lr: the form a
`torch.optim.lr_scheduler.LambdaLR` takes, as `make_scheduler` takes the
cosine one."""

from __future__ import annotations

import math

import torch


def _warm(step: int, warmup_steps: int) -> float:
    return step / max(warmup_steps, 1)


def _progress(step: int, warmup_steps: int, total_steps: int) -> float:
    return min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)


def cosine_with_warmup(warmup_steps: int, total_steps: int):
    """Linear warmup 0 -> 1, then cosine decay 1 -> 0."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return min(_warm(step, warmup_steps), 1.0)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * _progress(step, warmup_steps, total_steps))))

    return factor


def constant_with_warmup(warmup_steps: int):
    """Linear warmup 0 -> 1, then 1 (0 at step 0 even without warmup)."""
    return lambda step: min(_warm(step, warmup_steps), 1.0)


def linear_with_warmup(warmup_steps: int, total_steps: int):
    """Linear warmup 0 -> 1, then linear decay to 0 at `total_steps`."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return _warm(step, warmup_steps)
        return max(0.0, (total_steps - step) / max(total_steps - warmup_steps, 1))

    return factor


def inverse_sqrt_with_warmup(warmup_steps: int):
    """Linear warmup 0 -> 1, then sqrt(warmup / step); with no warmup the
    timescale is 10000, as in transformers."""
    timescale = warmup_steps if warmup_steps > 0 else 10_000

    def factor(step: int) -> float:
        if step < warmup_steps:
            return _warm(step, warmup_steps)
        return math.sqrt(timescale / max(step, timescale))

    return factor


def cosine_with_restarts_warmup(warmup_steps: int, total_steps: int, num_cycles: int = 1):
    """Linear warmup 0 -> 1, then `num_cycles` cosine decays 1 -> 0 with hard
    restarts, and 0 from `total_steps` on."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return _warm(step, warmup_steps)
        progress = _progress(step, warmup_steps, total_steps)
        if progress >= 1.0:
            return 0.0
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((progress * num_cycles) % 1.0))))

    return factor


def polynomial_with_warmup(lr: float, warmup_steps: int, total_steps: int, lr_end: float = 1e-7,
                           power: float = 1.0):
    """Linear warmup 0 -> 1, then polynomial decay of the rate lr -> lr_end
    (the multiplier ends at lr_end / lr, so it needs the base rate)."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return _warm(step, warmup_steps)
        if step > total_steps:
            return lr_end / lr
        remaining = 1.0 - _progress(step, warmup_steps, total_steps)
        return ((lr - lr_end) * remaining ** power + lr_end) / lr

    return factor


def warmup_stable_decay(warmup_steps: int, total_steps: int, decay_fraction: float = 0.1):
    """Linear warmup 0 -> 1, then 1, then linear decay to 0 over the last
    `decay_fraction` of `total_steps`."""
    decay_steps = decay_fraction * total_steps
    decay_start = total_steps - decay_steps

    def factor(step: int) -> float:
        if step < warmup_steps:
            return _warm(step, warmup_steps)
        if step < decay_start:
            return 1.0
        return min(max((total_steps - step) / max(decay_steps, 1), 0.0), 1.0)

    return factor


def make_scheduler(optimizer: torch.optim.Optimizer, lr: float, warmup_steps: int, total_steps: int,
                   start_step: int = 0) -> torch.optim.lr_scheduler.LambdaLR:
    """LambdaLR over `cosine_with_warmup` with optax's convention: the k-th
    update (0-based, counted from `start_step` on resume) uses the rate of
    step k, so the first update of a fresh run uses step 0's rate. Call
    `.step()` after every `optimizer.step()`."""
    for group in optimizer.param_groups:
        group["initial_lr"] = lr
    return torch.optim.lr_scheduler.LambdaLR(optimizer, cosine_with_warmup(warmup_steps, total_steps),
                                             last_epoch=start_step - 1)
