"""Transformer blocks of the DiT-Conv estimator and the text encoder.

Reference layers (models/diffusion_transformer.py:10-205): partial RoPE in the
concatenated-halves form, adaLN-Zero 6-way modulation, a k=3 conv FFN and a
key-padding attention mask. Parameters carry the reference torch names and
layouts (1x1 projections are Conv1d [out, in, 1]); activations are
channels-last [B, T, C], conditioning vectors [B, C], masks [B, T].

Training modules take `gen`, the trainer's `torch.Generator` on the
activations' device: every dropout draws from it, and `gen=None` means no
dropout (the JAX package's `deterministic=True`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.ops import philox
from stabletts_torch.ops.dit_attention_train_cuda import dit_attention_train
from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block
from stabletts_torch.ops.ffn_train_cuda import ffn_train


def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawing its mask from `gen` (identity when gen is
    None or p == 0), as flax's nn.Dropout: keep with probability 1 - p and
    scale kept values by 1 / (1 - p)."""
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def conv1d_same(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Channels-last conv with SAME zero padding: x [B, T, Cin] -> [B, T, Cout]."""
    k = conv.weight.shape[-1]
    if k == 1:
        return F.linear(x, conv.weight[..., 0], conv.bias)
    return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias, padding=k // 2).transpose(1, 2)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """[B] timesteps -> [B, dim], computed in f32, returned in t's dtype."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    args = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).to(t.dtype)


class TimestepEmbedding(nn.Module):
    """Linear -> SiLU -> Linear over the sinusoidal embedding."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int):
        super().__init__()
        self.layer = nn.Sequential(
            nn.Linear(in_channels, filter_channels),
            nn.SiLU(),
            nn.Linear(filter_channels, out_channels),
        )

    def forward(self, x):
        return self.layer(x)


class FiLMLayer(nn.Module):
    """gamma * x + beta with (gamma, beta) = film(c)."""

    def __init__(self, in_channels: int, cond_channels: int):
        super().__init__()
        self.film = nn.Conv1d(cond_channels, 2 * in_channels, 1)

    def forward(self, x, c):
        """x [B, T, C], c [B, cond]."""
        gamma, beta = F.linear(c, self.film.weight[..., 0], self.film.bias)[:, None, :].chunk(2, dim=-1)
        return gamma * x + beta


class MultiHeadAttention(nn.Module):
    """The attention half's 1x1-conv projections. Its math (partial RoPE,
    key-padding mask, exp2 softmax) runs inside `dit_block`."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)


class FFN(nn.Module):
    """The conv FFN's weights (k=3 conv -> SiLU -> k=3 conv, masked at every
    conv boundary); its math runs inside `dit_block`."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size, padding=kernel_size // 2)


class DiTConVBlock(nn.Module):
    """DiT block with adaLN-Zero conditioning and a conv FFN.

    In training (`self.training` with autograd on) the forward is the
    attention half `ops.dit_attention_train_cuda.dit_attention_train` (the
    port of the TPU kernel fused_dit_attention_train) then the FFN half
    `ops.ffn_train_cuda.ffn_train` (the port of fused_adaln_ffn_train), each
    a differentiable pair of CUDA kernels on the GPU with attention-weight and
    FFN dropout `p_dropout` drawn from `gen`. Otherwise it is one call of
    `ops.dit_block_cuda.dit_block` (the inference kernel on the GPU). Any T
    works on both paths."""

    def __init__(self, hidden_channels: int, filter_channels: int, num_heads: int,
                 kernel_size: int = 3, gin_channels: int = 0, p_dropout: float = 0.0):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("DiTConVBlock: the fused block hard-codes kernel_size 3")
        self.num_heads = num_heads
        self.p_dropout = p_dropout
        self.attn = MultiHeadAttention(hidden_channels, hidden_channels)
        self.mlp = FFN(hidden_channels, hidden_channels, filter_channels, kernel_size)
        proj = nn.Identity() if gin_channels == hidden_channels else nn.Linear(gin_channels, hidden_channels)
        self.adaLN_modulation = nn.Sequential(proj, nn.SiLU(), nn.Linear(hidden_channels, 6 * hidden_channels))
        # adaLN-Zero: the block is the identity at init
        nn.init.zeros_(self.adaLN_modulation[2].weight)
        nn.init.zeros_(self.adaLN_modulation[2].bias)
        self._packed = None

    def kernel_weights(self) -> DiTWeights:
        """Kernel-layout copies of the weights, rebuilt only when a parameter
        was replaced, moved, cast or written in place (load_state_dict)."""
        params = (self.attn.conv_q.weight, self.attn.conv_q.bias, self.attn.conv_k.weight,
                  self.attn.conv_k.bias, self.attn.conv_v.weight, self.attn.conv_v.bias,
                  self.attn.conv_o.weight, self.attn.conv_o.bias, self.mlp.conv_1.weight,
                  self.mlp.conv_1.bias, self.mlp.conv_2.weight, self.mlp.conv_2.bias)
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in params)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                a = self.attn
                dense = lambda conv: conv.weight[..., 0].t()
                w = DiTWeights(
                    wqkv=torch.cat([dense(a.conv_q), dense(a.conv_k), dense(a.conv_v)], dim=1).contiguous(),
                    bqkv=torch.cat([a.conv_q.bias, a.conv_k.bias, a.conv_v.bias]).contiguous(),
                    wo=dense(a.conv_o).contiguous(),
                    bo=a.conv_o.bias.detach().clone(),
                    w1=self.mlp.conv_1.weight.permute(2, 1, 0).contiguous(),
                    b1=self.mlp.conv_1.bias.detach().clone(),
                    w2=self.mlp.conv_2.weight.permute(2, 1, 0).contiguous(),
                    b2=self.mlp.conv_2.bias.detach().clone(),
                )
            self._packed = (key, w)
        return self._packed[1]

    def forward(self, x, c, mask, gen: Optional[torch.Generator] = None):
        """x [B, T, C], c [B, gin], mask [B, T] -> [B, T, C]."""
        b, _, ch = x.shape
        x = x * mask.to(x.dtype)[..., None]
        mods = self.adaLN_modulation(c).view(b, 6, ch)
        if not (self.training and torch.is_grad_enabled()):
            return dit_block(x.contiguous(), mods.contiguous(), mask, self.kernel_weights(), self.num_heads)
        rate = self.p_dropout if gen is not None else 0.0
        seed = lambda: philox.draw_seed(gen, x.device) if rate > 0.0 else None
        dense = lambda conv: conv.weight[..., 0].t()
        a = self.attn
        x = dit_attention_train(x, mods[:, :3], mask, dense(a.conv_q), a.conv_q.bias, dense(a.conv_k),
                                a.conv_k.bias, dense(a.conv_v), a.conv_v.bias, dense(a.conv_o), a.conv_o.bias,
                                self.num_heads, rate, seed())
        return ffn_train(x, mods[:, 3:], mask, self.mlp.conv_1.weight.permute(2, 1, 0), self.mlp.conv_1.bias,
                         self.mlp.conv_2.weight.permute(2, 1, 0), self.mlp.conv_2.bias, rate, seed())
