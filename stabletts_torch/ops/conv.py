"""Convolution helpers on channels-last tensors with the JAX package's kernel
layout [k, C_in, C_out] (its `ops/conv.py`), as plain functions on tensors."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv1d_same_dots(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """SAME-padded 1D conv as k shifted products: y[t] = sum_j x[t + j - (k-1)//2] @ K[j]
    (for even k the padding is (k-1)//2 before and k//2 after). x [B, T, C_in]."""
    k = kernel.shape[0]
    half = (k - 1) // 2
    y = x @ kernel[half]
    for j in range(k):
        off = j - half  # y[t] += (x @ K[j])[t + off]
        if off == 0:
            continue
        d = x @ kernel[j]
        if off > 0:
            y = y + F.pad(d[:, off:, :], (0, 0, 0, off))
        else:
            y = y + F.pad(d[:, :off, :], (0, 0, -off, 0))
    return y + bias


def conv_transpose_1d(x: torch.Tensor, kernel: torch.Tensor, stride: int, padding: int,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.nn.ConvTranspose1d on channels-last input: x [B, T, C_in], kernel
    [k, C_in, C_out] (torch's [C_in, C_out, k] permuted, taps not flipped) ->
    [B, (T-1)*stride - 2*padding + k, C_out]."""
    out = F.conv_transpose1d(x.transpose(1, 2), kernel.permute(1, 2, 0), bias, stride=stride, padding=padding)
    return out.transpose(1, 2)


def conv1d_dilated(x: torch.Tensor, kernel: torch.Tensor, dilation: int, padding: int,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dilated 1D conv on channels-last input: x [B, T, C_in], kernel
    [k, C_in, C_out], `padding` zeros at both ends."""
    out = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), bias, padding=padding, dilation=dilation)
    return out.transpose(1, 2)
