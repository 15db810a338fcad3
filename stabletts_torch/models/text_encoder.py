"""Text encoder: phoneme embedding + DiT-Conv blocks conditioned on the style
vector (reference: models/text_encoder.py:8-44)."""

from __future__ import annotations

import torch.nn as nn

from stabletts_torch.nn.blocks import DiTConVBlock, conv1d_same
from stabletts_torch.ops.mask import sequence_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int, gin_channels: int, p_dropout: float = 0.0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels ** -0.5)
        self.encoder = nn.ModuleList(
            DiTConVBlock(hidden_channels, filter_channels, n_heads, kernel_size, gin_channels, p_dropout)
            for _ in range(n_layers)
        )
        self.proj = nn.Conv1d(hidden_channels, out_channels, 1)

    def forward(self, x, c, x_lengths, gen=None):
        """x [B, T] ids, c [B, gin] -> (hidden [B, T, H], mu_x [B, T, out], mask [B, T])."""
        h = self.emb(x) * (self.hidden_channels ** 0.5)
        mask = sequence_mask(x_lengths, x.shape[1], dtype=h.dtype)
        for block in self.encoder:
            h = block(h, c, mask, gen)
        mu_x = conv1d_same(h, self.proj) * mask[..., None]
        return h, mu_x, mask
