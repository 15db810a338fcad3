"""Masking utilities. Sequence tensors are channels-last [B, T, C]; masks are
[B, T] and broadcast as [..., T, 1] against channel dims."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int, dtype=torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, max_length] mask, 1.0 for valid positions."""
    pos = torch.arange(max_length, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)
