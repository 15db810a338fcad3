"""VITS-style duration predictor on stop-gradient features, and its loss
(reference: models/duration_predictor.py:5-40)."""

from __future__ import annotations

import torch
import torch.nn as nn

from stabletts_torch.nn.blocks import conv1d_same, dropout


class DurationPredictor(nn.Module):
    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int, gin_channels: int,
                 p_dropout: float = 0.5):
        super().__init__()
        pad = kernel_size // 2
        self.p_dropout = p_dropout
        self.cond = nn.Conv1d(gin_channels, in_channels, 1)
        self.conv1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=pad)
        self.norm1 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.conv2 = nn.Conv1d(filter_channels, filter_channels, kernel_size, padding=pad)
        self.norm2 = nn.LayerNorm(filter_channels, eps=1e-5)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, mask, g, gen=None):
        """x [B, T, C] encoder hidden, mask [B, T], g [B, gin] -> log-durations
        [B, T, 1]. x and g are detached where the reference detaches them, so
        the predictor trains without touching the encoders; dropout after each
        norm draws from `gen` (none when gen is None)."""
        m = mask[..., None]
        x = x.detach() + conv1d_same(g.detach(), self.cond)[:, None, :]
        x = dropout(self.norm1(torch.relu(conv1d_same(x * m, self.conv1))), self.p_dropout, gen)
        x = dropout(self.norm2(torch.relu(conv1d_same(x * m, self.conv2))), self.p_dropout, gen)
        return conv1d_same(x * m, self.proj) * m


def duration_loss(logw, logw_, lengths, total=None):
    """MSE over log-durations normalised by the total text length, in f32;
    `total` stands for lengths.sum() (a data-parallel step's global sum)."""
    return ((logw - logw_).float() ** 2).sum() / (lengths.sum() if total is None else total)
