"""VITS-style duration predictor, inference forward
(reference: models/duration_predictor.py:5-40)."""

from __future__ import annotations

import torch
import torch.nn as nn

from stabletts_torch.nn.blocks import conv1d_same


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int, gin_channels: int):
        super().__init__()
        pad = kernel_size // 2
        self.cond = nn.Conv1d(gin_channels, in_channels, 1)
        self.conv1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=pad)
        self.norm1 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.conv2 = nn.Conv1d(filter_channels, filter_channels, kernel_size, padding=pad)
        self.norm2 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, mask, g):
        """x [B, T, C] encoder hidden, mask [B, T], g [B, gin] -> log-durations [B, T, 1]."""
        m = mask[..., None]
        x = x + conv1d_same(g, self.cond)[:, None, :]
        x = self.norm1(torch.relu(conv1d_same(x * m, self.conv1)))
        x = self.norm2(torch.relu(conv1d_same(x * m, self.conv2)))
        return conv1d_same(x * m, self.proj) * m

