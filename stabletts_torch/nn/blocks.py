"""Transformer blocks of the DiT-Conv estimator and the text encoder.

Reference layers (models/diffusion_transformer.py:10-205): partial RoPE in the
concatenated-halves form, adaLN-Zero 6-way modulation, a k=3 conv FFN and a
key-padding attention mask. Parameters carry the reference torch names and
layouts (1x1 projections are Conv1d [out, in, 1]); activations are
channels-last [B, T, C], conditioning vectors [B, C], masks [B, T].

Training modules take `gen`, the trainer's `torch.Generator` on the
activations' device or a `parallel.mesh.RowWindow` over it (a data-parallel
rank's rows of the global batch): every dropout draws from it, and
`gen=None` means no dropout (the JAX package's `deterministic=True`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.ops import philox
from stabletts_torch.parallel import mesh
from stabletts_torch.ops.attention import attn_bias_from_mask, masked_attention
from stabletts_torch.ops.dit_attention_cuda import dit_attention
from stabletts_torch.ops.dit_attention_train_cuda import dit_attention_train
from stabletts_torch.ops.dit_block_cuda import DiTWeights, apply_rope, dit_block, packed_weights, rope_tables
from stabletts_torch.ops.ffn_train_cuda import ffn_train


def dropout(x: torch.Tensor, p: float, gen) -> torch.Tensor:
    """Inverted dropout drawing its mask from `gen` (identity when gen is
    None or p == 0), as flax's nn.Dropout: keep with probability 1 - p and
    scale kept values by 1 / (1 - p). x's first dimension is the batch: a
    `RowWindow` draws the global batch's mask and keeps its rows."""
    if gen is None or p == 0.0:
        return x
    keep = mesh.rows_rand(gen, x.shape, x.device) >= p
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
    """Self-attention with 1x1-conv projections and partial RoPE (rotary dim
    = head_dim / 2). The fused kernels (`dit_block`, `dit_attention`,
    `dit_attention_train`) read the weights and do this math themselves;
    `forward` is the composed reference in plain PyTorch around the attention
    core: `ops.attention.masked_attention` in inference; in training
    (`train=True`) einsum, softmax and dropout on the softmax weights in
    plain PyTorch on any device."""

    def __init__(self, channels: int, out_channels: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)

    def qkv(self, x):
        """x [B, T, C] -> q, k, v [B, T, H, D], q and k rotated."""
        b, t, c = x.shape
        d = c // self.n_heads
        heads = lambda z: z.reshape(b, t, self.n_heads, d)
        cos, sin = rope_tables(t, d, x.device)
        q = apply_rope(heads(conv1d_same(x, self.conv_q)), cos, sin)
        k = apply_rope(heads(conv1d_same(x, self.conv_k)), cos, sin)
        return q, k, heads(conv1d_same(x, self.conv_v))

    def forward(self, x, mask: Optional[torch.Tensor] = None, train: bool = False, p_dropout: float = 0.0,
                gen: Optional[torch.Generator] = None):
        """x [B, T, C], mask [B, T] (keys only) -> [B, T, out_channels].
        `train` takes the differentiable core; its dropout `p_dropout` draws
        from `gen` (none when gen is None)."""
        b, t, c = x.shape
        q, k, v = self.qkv(x)
        if train:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
            if mask is not None:
                logits = logits + attn_bias_from_mask(mask.to(x.dtype), dtype=x.dtype)
            weights = dropout(torch.softmax(logits, dim=-1), p_dropout, gen)
            out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, t, c)
        else:
            out = masked_attention(q, k, v, mask=mask).reshape(b, t, c)
        return conv1d_same(out, self.conv_o)


class FFN(nn.Module):
    """Conv FFN: conv -> SiLU -> dropout -> conv, masked at every conv
    boundary. The fused kernels read the weights and do this math themselves
    (3 taps only); `forward` is the composed path in plain PyTorch, for any
    odd kernel size, in inference and in training."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=kernel_size // 2)
        self.conv_2 = nn.Conv1d(filter_channels, out_channels, kernel_size, padding=kernel_size // 2)

    def forward(self, x, mask, p_dropout: float = 0.0, gen: Optional[torch.Generator] = None):
        """x [B, T, C], mask [B, T] -> [B, T, out_channels]; dropout
        `p_dropout` after the SiLU draws from `gen` (none when gen is None)."""
        m = mask.to(x.dtype)[..., None]
        x = dropout(F.silu(conv1d_same(x * m, self.conv_1)), p_dropout, gen)
        return conv1d_same(x * m, self.conv_2) * m


def _modulate(x, shift, scale):
    return x * (1 + scale) + shift


class DiTConVBlock(nn.Module):
    """DiT block with adaLN-Zero conditioning and a conv FFN.

    One path each way, chosen by the module's mode and kernel size alone.
    Eval: one `dit_block` call (the whole-block kernel) for 3 taps; for
    another kernel size `dit_attention`, then the composed FFN (the FFN
    kernels have 3 taps). Train (`self.training`, also under
    `torch.no_grad()`: a validation pass keeps its dropout): the
    differentiable `dit_attention_train`, then `ffn_train` for 3 taps, else
    the composed FFN; attention-weight and FFN dropout `p_dropout` draw from
    `gen`. `MultiHeadAttention.forward` and `FFN.forward` are the composed
    references the kernels are held to. Every wrapper runs its plain version
    on a CPU tensor; any T works."""

    def __init__(self, hidden_channels: int, filter_channels: int, num_heads: int,
                 kernel_size: int = 3, gin_channels: int = 0, p_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.p_dropout = p_dropout
        self.attn = MultiHeadAttention(hidden_channels, hidden_channels, num_heads)
        self.mlp = FFN(hidden_channels, hidden_channels, filter_channels, kernel_size)
        proj = nn.Identity() if gin_channels == hidden_channels else nn.Linear(gin_channels, hidden_channels)
        self.adaLN_modulation = nn.Sequential(proj, nn.SiLU(), nn.Linear(hidden_channels, 6 * hidden_channels))
        # adaLN-Zero: the block is the identity at init
        nn.init.zeros_(self.adaLN_modulation[2].weight)
        nn.init.zeros_(self.adaLN_modulation[2].bias)
        self._packed = None

    def kernel_weights(self) -> DiTWeights:
        """Kernel-layout copies of the weights (see `packed_weights`)."""
        a, m = self.attn, self.mlp
        dense = lambda conv: conv.weight[..., 0].t()
        taps = lambda conv: conv.weight.permute(2, 1, 0)
        pack = lambda: (torch.cat([dense(a.conv_q), dense(a.conv_k), dense(a.conv_v)], dim=1),
                        torch.cat([a.conv_q.bias, a.conv_k.bias, a.conv_v.bias]), dense(a.conv_o), a.conv_o.bias,
                        taps(m.conv_1), m.conv_1.bias, taps(m.conv_2), m.conv_2.bias)
        return packed_weights(self, (a.conv_q, a.conv_k, a.conv_v, a.conv_o, m.conv_1, m.conv_2), pack)

    def _inference(self, x, mods, mask):
        """x [B, T, C] (masked), mods [B, 6, C] -> [B, T, C]."""
        w = self.kernel_weights()
        if self.kernel_size == 3:
            return dit_block(x, mods, mask, w, self.num_heads)
        x = dit_attention(x, mods[:, :3].contiguous(), mask, w.wqkv, w.bqkv, w.wo, w.bo, self.num_heads)
        return self._composed_ffn(x, mods, mask)

    def _composed_ffn(self, x, mods, mask, p_dropout: float = 0.0, gen=None):
        """The FFN half around `FFN.forward`, for a kernel size other than 3."""
        shift, scale, gate = mods[:, 3:, None, :].unbind(1)
        h = _modulate(F.layer_norm(x, (x.shape[-1],), eps=1e-5), shift, scale)
        return x + gate * self.mlp(h, mask, p_dropout, gen)

    def forward(self, x, c, mask, gen: Optional[torch.Generator] = None):
        """x [B, T, C], c [B, gin], mask [B, T] -> [B, T, C]."""
        b, _, ch = x.shape
        x = x * mask.to(x.dtype)[..., None]
        mods = self.adaLN_modulation(c).view(b, 6, ch)
        if not self.training:
            return self._inference(x.contiguous(), mods.contiguous(), mask)
        rate = self.p_dropout if gen is not None else 0.0
        seed = lambda: philox.draw_seed(mesh.generator_of(gen), x.device) if rate > 0.0 else None
        row0 = mesh.row0_of(gen)
        dense = lambda conv: conv.weight[..., 0].t()
        a, m = self.attn, self.mlp
        x = dit_attention_train(x, mods[:, :3], mask, dense(a.conv_q), a.conv_q.bias, dense(a.conv_k), a.conv_k.bias,
                                dense(a.conv_v), a.conv_v.bias, dense(a.conv_o), a.conv_o.bias, self.num_heads, rate,
                                seed(), row0=row0)
        if self.kernel_size == 3:
            return ffn_train(x, mods[:, 3:], mask, m.conv_1.weight.permute(2, 1, 0), m.conv_1.bias,
                             m.conv_2.weight.permute(2, 1, 0), m.conv_2.bias, rate, seed(), row0=row0)
        return self._composed_ffn(x, mods, mask, self.p_dropout, gen)
