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
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.ops import philox
from stabletts_torch.parallel import mesh
from stabletts_torch.ops.adaln_ffn_cuda import adaln_ffn
from stabletts_torch.ops.attention import attn_bias_from_mask, masked_attention, resolve_impl
from stabletts_torch.ops.attention_packed_cuda import attention_packed_t
from stabletts_torch.ops.attention_train_cuda import attention_train
from stabletts_torch.ops.dit_attention_cuda import dit_attention
from stabletts_torch.ops.dit_attention_train_cuda import dit_attention_train
from stabletts_torch.ops.dit_block_cuda import DiTWeights, apply_rope, dit_block, rope_tables
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
    `forward` is the composed path in plain PyTorch around the attention core.
    Inference: `ops.attention.masked_attention` (the packed-head kernel on the
    GPU) or, with STABLETTS_ATTN_LAYOUT=tminor, `attention_packed_t` on
    channel-major [B, C, T] operands. Training (`train=True`): the
    differentiable `ops.attention_train_cuda.attention_train` with dropout on
    the softmax weights when `ops.attention.resolve_impl` says `fused`, else
    einsum, softmax and dropout in plain PyTorch, as in the JAX package."""

    def __init__(self, channels: int, out_channels: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, out_channels, 1)

    def forward(self, x, mask: Optional[torch.Tensor] = None, train: bool = False, p_dropout: float = 0.0,
                gen: Optional[torch.Generator] = None):
        """x [B, T, C], mask [B, T] (keys only) -> [B, T, out_channels].
        `train` takes the differentiable core; its dropout `p_dropout` draws
        from `gen` (none when gen is None)."""
        b, t, c = x.shape
        d = c // self.n_heads
        heads = lambda z: z.reshape(b, t, self.n_heads, d)
        cos, sin = rope_tables(t, d, x.device)
        q = apply_rope(heads(conv1d_same(x, self.conv_q)), cos, sin)
        k = apply_rope(heads(conv1d_same(x, self.conv_k)), cos, sin)
        v = heads(conv1d_same(x, self.conv_v))
        if train:
            rate = p_dropout if gen is not None else 0.0
            if resolve_impl(None, x.device) == "fused":
                seed = philox.draw_seed(mesh.generator_of(gen), x.device) if rate > 0.0 else None
                out = attention_train(q.reshape(b, t, c), k.reshape(b, t, c), v.reshape(b, t, c), mask, rate, seed,
                                      self.n_heads, mesh.row0_of(gen))
            else:
                logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(d))
                if mask is not None:
                    logits = logits + attn_bias_from_mask(mask.to(x.dtype), dtype=x.dtype)
                weights = dropout(torch.softmax(logits, dim=-1), rate, gen)
                out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, t, c)
        elif os.environ.get("STABLETTS_ATTN_LAYOUT") == "tminor":
            to_t = lambda z: z.reshape(b, t, c).transpose(1, 2).contiguous()
            out = attention_packed_t(to_t(q), to_t(k), to_t(v), mask, n_heads=self.n_heads).transpose(1, 2)
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

    In training (`self.training`) the block takes one of the JAX package's
    training configurations, chosen by the same variables with the same values,
    defaults and precedence, read at every call; attention-weight and FFN
    dropout `p_dropout` draw from `gen`:

      default                     the attention half `dit_attention_train`
                                  (the port of fused_dit_attention_train) then
                                  the FFN half `ffn_train` (the port of
                                  fused_adaln_ffn_train), each a differentiable
                                  pair of CUDA kernels on the GPU
      STABLETTS_ATTN_TRAIN=xla    the attention half composed in plain PyTorch
                                  around `attention_train` (the port of
                                  fused_attention_train; with
                                  STABLETTS_ATTN_IMPL=xla or flash, or on the
                                  CPU under auto, einsum + softmax + dropout)
      STABLETTS_FFN_TRAIN=xla     the FFN half composed in plain PyTorch convs
                                  with dropout (also for a kernel size other
                                  than 3: the FFN kernels have 3 taps)

    The gate is `self.training` alone, as the JAX gate is `deterministic`
    alone: a forward in train mode under `torch.no_grad()` (a validation pass
    that keeps dropout on) takes the training path and its dropout, not the
    inference kernels. The JAX gates `_on_tpu()` and `T % 8 == 0` exist for
    the TPU kernels' tiles and have no counterpart here.

    In eval mode the block takes one of the JAX package's inference
    configurations, chosen by the same environment variables with the same
    values and precedence, read at every call:

      default                  one `dit_block` call (the whole-block kernel)
      STABLETTS_DIT_BLOCK=0    `dit_attention` then `adaln_ffn` (two kernels)
      STABLETTS_DIT_FUSED=0    the attention half composed in plain PyTorch
                               around `masked_attention` (STABLETTS_ATTN_IMPL
                               = auto | fused | flash | xla picks its core;
                               STABLETTS_ATTN_LAYOUT=tminor takes
                               `attention_packed_t`), then the FFN half
      STABLETTS_FFN_IMPL=xla   the FFN half composed in plain PyTorch convs

    A kernel size other than 3 takes the composed FFN (the FFN kernels have 3
    taps). Every wrapper runs its plain version on a CPU tensor. Any T works
    on every path."""

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

    def _inference(self, x, mods, mask):
        """x [B, T, C] (masked), mods [B, 6, C] -> [B, T, C] under the
        configuration the environment names (see the class docstring)."""
        env = os.environ.get
        ch = x.shape[-1]
        fuse_halves = env("STABLETTS_DIT_FUSED", "1") == "1"
        three_taps = self.kernel_size == 3
        if fuse_halves and env("STABLETTS_DIT_BLOCK", "1") == "1" and three_taps:
            return dit_block(x, mods, mask, self.kernel_weights(), self.num_heads)
        m = mask.to(x.dtype)[..., None]
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[:, :, None, :].unbind(1)
        if fuse_halves:
            w = self.kernel_weights()
            x = dit_attention(x, mods[:, :3].contiguous(), mask, w.wqkv, w.bqkv, w.wo, w.bo, self.num_heads)
        else:
            h = _modulate(F.layer_norm(x, (ch,), eps=1e-5), shift_msa, scale_msa)
            x = x + gate_msa * self.attn(h, mask) * m
        if env("STABLETTS_FFN_IMPL", "fused") == "fused" and three_taps:
            w = self.kernel_weights()
            return adaln_ffn(x, mods[:, 3:].contiguous(), mask, w.w1, w.b1, w.w2, w.b2)
        h = _modulate(F.layer_norm(x, (ch,), eps=1e-5), shift_mlp, scale_mlp)
        return x + gate_mlp * self.mlp(h, mask)

    def forward(self, x, c, mask, gen: Optional[torch.Generator] = None):
        """x [B, T, C], c [B, gin], mask [B, T] -> [B, T, C]."""
        b, _, ch = x.shape
        x = x * mask.to(x.dtype)[..., None]
        mods = self.adaLN_modulation(c).view(b, 6, ch)
        if not self.training:
            return self._inference(x.contiguous(), mods.contiguous(), mask)
        env = os.environ.get
        rate = self.p_dropout if gen is not None else 0.0
        seed = lambda: philox.draw_seed(mesh.generator_of(gen), x.device) if rate > 0.0 else None
        row0 = mesh.row0_of(gen)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[:, :, None, :].unbind(1)
        if env("STABLETTS_ATTN_TRAIN", "fused") == "fused":
            dense = lambda conv: conv.weight[..., 0].t()
            a = self.attn
            x = dit_attention_train(x, mods[:, :3], mask, dense(a.conv_q), a.conv_q.bias, dense(a.conv_k),
                                    a.conv_k.bias, dense(a.conv_v), a.conv_v.bias, dense(a.conv_o), a.conv_o.bias,
                                    self.num_heads, rate, seed(), row0=row0)
        else:
            h = _modulate(F.layer_norm(x, (ch,), eps=1e-5), shift_msa, scale_msa)
            x = x + gate_msa * self.attn(h, mask, True, self.p_dropout, gen) * mask.to(x.dtype)[..., None]
        if env("STABLETTS_FFN_TRAIN", "fused") == "fused" and self.kernel_size == 3:
            return ffn_train(x, mods[:, 3:], mask, self.mlp.conv_1.weight.permute(2, 1, 0), self.mlp.conv_1.bias,
                             self.mlp.conv_2.weight.permute(2, 1, 0), self.mlp.conv_2.bias, rate, seed(), row0=row0)
        h = _modulate(F.layer_norm(x, (ch,), eps=1e-5), shift_mlp, scale_mlp)
        return x + gate_mlp * self.mlp(h, mask, self.p_dropout, gen)
