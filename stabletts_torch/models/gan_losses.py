"""GAN vocoder losses (reference: vocoders/vocos/models/loss.py).

Every mel scale runs through the port's `ops.stft.log_mel_spectrogram`; the
reductions run in f32 whatever the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from stabletts_torch.config import MelConfig
from stabletts_torch.ops.stft import log_mel_spectrogram


def multi_scale_mel_configs(
    base: MelConfig,
    n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
    window_lengths: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
) -> Tuple[MelConfig, ...]:
    """7-scale mel configs (reference: loss.py:10-18): hop = win / 4."""
    return tuple(
        dataclasses.replace(base, n_mels=m, n_fft=w, win_length=w, hop_length=w // 4, pad=0)
        for m, w in zip(n_mels, window_lengths)
    )


def single_scale_mel_loss(x: torch.Tensor, y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(reference: loss.py:27-35). x, y: [B, T] waveforms, f32."""
    return (log_mel_spectrogram(x, cfg) - log_mel_spectrogram(y, cfg)).abs().mean()


def multi_scale_mel_loss(x: torch.Tensor, y: torch.Tensor, configs: Tuple[MelConfig, ...]) -> torch.Tensor:
    """Sum of L1 log-mel distances across scales (reference: loss.py:24-25)."""
    return sum(single_scale_mel_loss(x, y, cfg) for cfg in configs)


def feature_loss(fmap_r: List[List[torch.Tensor]], fmap_g: List[List[torch.Tensor]]) -> torch.Tensor:
    """Feature-matching L1, doubled (reference: loss.py:37-43)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl.float() - gl.float()).abs().mean()
    return loss * 2


def discriminator_loss(disc_real: List[torch.Tensor], disc_gen: List[torch.Tensor]):
    """LSGAN discriminator loss (reference: loss.py:50-61): (sum, per-discriminator
    real losses, per-discriminator fake losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r_loss = ((1 - dr.float()) ** 2).mean()
        g_loss = (dg.float() ** 2).mean()
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: List[torch.Tensor]):
    """LSGAN generator loss (reference: loss.py:63-70)."""
    gen_losses = [((1 - dg.float()) ** 2).mean() for dg in disc_outputs]
    return sum(gen_losses), gen_losses
