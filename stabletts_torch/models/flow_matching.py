"""Conditional flow-matching decoder (reference: models/flow_matching.py:11-100).
Sampling integrates dx/dt = v(t, x | mu, c) in `models/sampler.py`; this
module evaluates the velocity field and the training loss."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from stabletts_torch.models.estimator import Decoder


class CFMDecoder(nn.Module):
    def __init__(self, noise_channels, cond_channels, hidden_channels, out_channels, filter_channels,
                 n_heads, n_layers, kernel_size, gin_channels, p_dropout=0.0, sigma_min: float = 1e-4,
                 remat: bool = False):
        super().__init__()
        self.sigma_min = sigma_min
        self.estimator = Decoder(
            noise_channels=noise_channels, cond_channels=cond_channels,
            hidden_channels=hidden_channels, out_channels=out_channels,
            filter_channels=filter_channels, n_layers=n_layers, n_heads=n_heads,
            kernel_size=kernel_size, gin_channels=gin_channels, p_dropout=p_dropout, remat=remat,
        )

    def forward(self, t, x, mask, mu, c, mu_is_precomputed: bool = False):
        return self.estimator(t, x, mask, mu, c, mu_is_precomputed)

    def compute_loss(self, x1, mask, mu, c, t_rand, noise, gen=None, mask_total=None):
        """OT-CFM loss with the cosine timestep warp
        (reference: flow_matching.py:69-100). x1: target mel [B, T, C];
        t_rand: U[0, 1) [B]; noise: standard normal like x1. Loss = masked
        sum of squares / (sum(mask) * C), reduced in f32; `mask_total` stands
        for sum(mask) (a data-parallel step's global sum). Returns (loss, y)."""
        t = 1 - torch.cos(t_rand * 0.5 * math.pi)
        t3 = t[:, None, None]
        y = (1 - (1 - self.sigma_min) * t3) * noise + t3 * x1
        u = x1 - (1 - self.sigma_min) * noise
        pred = self.estimator(t, y, mask, mu, c, gen=gen)
        total = mask.float().sum() if mask_total is None else mask_total
        loss = ((pred - u).float() ** 2).sum() / (total * u.shape[-1])
        return loss, y
