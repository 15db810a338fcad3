"""Flow-matching velocity estimator: DiT U-Net with FiLM timestep
conditioning and long skip connections (reference: models/estimator.py:8-137)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from stabletts_torch.nn.blocks import (
    DiTConVBlock,
    FiLMLayer,
    TimestepEmbedding,
    conv1d_same,
    sinusoidal_pos_emb,
)
from stabletts_torch.parallel import mesh


class DitWrapper(nn.Module):
    """FiLM(t) then DiTConVBlock(speaker c)."""

    def __init__(self, hidden_channels, filter_channels, num_heads, kernel_size, gin_channels, time_channels,
                 p_dropout=0.0):
        super().__init__()
        self.time_fusion = FiLMLayer(hidden_channels, time_channels)
        self.block = DiTConVBlock(hidden_channels, filter_channels, num_heads, kernel_size, gin_channels,
                                  p_dropout)

    def forward(self, x, c, t, mask, gen=None):
        x = self.time_fusion(x, t) * mask.to(x.dtype)[..., None]
        return self.block(x, c, mask, gen)


def checkpointed(block: nn.Module, gen, *args):
    """`block(*args, gen)` under `torch.utils.checkpoint` (non-reentrant): its
    activations are dropped after the forward and recomputed in the backward.

    checkpoint saves and restores only the default generators, and the
    blocks draw every dropout mask and kernel seed from the trainer's own
    `gen`. So the forward draws from `gen`, which then stands where a call
    without checkpoint leaves it, and the recompute draws the same values
    from a copy of `gen` set to its state before the forward. The recompute
    also runs on the tensors the forward ran on: the block's parameters as
    they are now (bf16 casts under a compute-dtype `functional_call`, gone by
    the time the backward runs)."""
    params = dict(block.named_parameters())
    state = None if gen is None else mesh.generator_of(gen).get_state()
    recompute = False

    def run(*xs):
        nonlocal recompute
        g = gen
        if recompute and gen is not None:
            g = mesh.forked(gen, state)
        recompute = True
        return torch.func.functional_call(block, params, (*xs, g))

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class Decoder(nn.Module):
    """Velocity network v(t, x | mu, c). x/mu [B, T, C], t [B], c [B, gin],
    mask [B, T]. The t-independent mu prenet is exposed as `precompute_mu` so
    the sampler runs it once per synthesis."""

    def __init__(self, noise_channels, cond_channels, hidden_channels, out_channels, filter_channels,
                 n_layers=1, n_heads=4, kernel_size=3, gin_channels=0, p_dropout=0.0, remat=False):
        super().__init__()
        if n_layers % 2 != 0:
            raise ValueError(f"n_layers must be even for the U-Net skips (got {n_layers})")
        pad = kernel_size // 2
        self.hidden_channels = hidden_channels
        self.remat = remat
        self.time_mlp = TimestepEmbedding(hidden_channels, hidden_channels, filter_channels)
        self.cond_proj = nn.Sequential(
            nn.Conv1d(cond_channels, filter_channels, kernel_size, padding=pad), nn.SiLU(),
            nn.Conv1d(filter_channels, filter_channels, kernel_size, padding=pad), nn.SiLU(),
            nn.Conv1d(filter_channels, hidden_channels, kernel_size, padding=pad),
        )
        self.in_proj = nn.Conv1d(noise_channels + hidden_channels, hidden_channels, 1)
        self.final_proj = nn.Conv1d(hidden_channels, out_channels, 1)
        self.blocks = nn.ModuleList(
            DitWrapper(hidden_channels, filter_channels, n_heads, kernel_size, gin_channels, hidden_channels,
                       p_dropout)
            for _ in range(n_layers)
        )
        self.lsc_layers = nn.ModuleList(
            nn.Conv1d(2 * hidden_channels, hidden_channels, kernel_size, padding=pad)
            for _ in range(n_layers // 2)
        )

    def precompute_mu(self, mu):
        """3x (conv k=3) with SiLU between, unmasked, on [B, T, cond]: three
        library convs in inference and in training (the port of the TPU
        kernel fused_prenet_train, `ops.prenet_train_cuda.prenet_train`, takes
        longer in its backward than these convs)."""
        c0, _, c2, _, c4 = self.cond_proj
        h = F.silu(conv1d_same(mu, c0))
        h = F.silu(conv1d_same(h, c2))
        return conv1d_same(h, c4)

    def forward(self, t, x, mask, mu, c, mu_is_precomputed: bool = False, gen=None):
        """`gen` draws the blocks' dropout in training (none when None). With
        `remat`, each block is `checkpointed` in training when a gradient is
        taken (the 6 estimator blocks only, as in the JAX package). The
        JAX package's training forward pads T to a multiple of 128 for its
        TPU kernels; the port's kernels take any T, and the block stack is
        mask-invariant, so it does not pad."""
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, self.hidden_channels, scale=1000.0))
        h_mu = mu if mu_is_precomputed else self.precompute_mu(mu)
        h = conv1d_same(torch.cat([x, h_mu], dim=-1), self.in_proj)  # (noise, mu) order

        n_lsc = len(self.lsc_layers)
        remat = self.remat and self.training and torch.is_grad_enabled()
        skips = []
        for idx, block in enumerate(self.blocks):
            if idx < n_lsc:
                skips.append(h)
            else:
                h = conv1d_same(torch.cat([h, skips.pop()], dim=-1), self.lsc_layers[idx - n_lsc])
            h = checkpointed(block, gen, h, c, t_emb, mask) if remat else block(h, c, t_emb, mask, gen)

        m = mask.to(h.dtype)[..., None]
        return conv1d_same(h * m, self.final_proj) * m
