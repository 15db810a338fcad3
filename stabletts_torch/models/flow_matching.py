"""Conditional flow-matching decoder (reference: models/flow_matching.py:11-100).
Sampling integrates dx/dt = v(t, x | mu, c) in `models/sampler.py`; this
module evaluates the velocity field."""

from __future__ import annotations

import torch.nn as nn

from stabletts_torch.models.estimator import Decoder


class CFMDecoder(nn.Module):
    def __init__(self, noise_channels, cond_channels, hidden_channels, out_channels, filter_channels,
                 n_heads, n_layers, kernel_size, gin_channels):
        super().__init__()
        self.estimator = Decoder(
            noise_channels=noise_channels, cond_channels=cond_channels,
            hidden_channels=hidden_channels, out_channels=out_channels,
            filter_channels=filter_channels, n_layers=n_layers, n_heads=n_heads,
            kernel_size=kernel_size, gin_channels=gin_channels,
        )

    def forward(self, t, x, mask, mu, c, mu_is_precomputed: bool = False):
        return self.estimator(t, x, mask, mu, c, mu_is_precomputed)
