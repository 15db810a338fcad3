"""Learning-rate schedule: transformers-style cosine with linear warmup
(reference: utils/scheduler.py:96-124, train.py:61)."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(warmup_steps: int, total_steps: int):
    """The multiplier of the base rate at update `step` (0-based): linear
    warmup 0 -> 1, then cosine decay 1 -> 0 (the JAX package's schedule
    divided by its lr)."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return min(step / max(warmup_steps, 1), 1.0)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

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
