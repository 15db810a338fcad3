"""Mel reference (style) encoder for zero-shot timbre cloning
(reference: models/reference_encoder.py:4-92). Plain tensor code: its
attention is small (2 heads over the reference mel). In training, dropout
(0.25 in StableTTS) follows each spectral layer, each GLU and the attention
weights, drawn from `gen`; `gen=None` means none."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.nn.blocks import conv1d_same, dropout
from stabletts_torch.ops.attention import masked_attention


class Conv1dGLU(nn.Module):
    """Conv1d + gated linear unit with a residual connection."""

    def __init__(self, channels: int, kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.p_dropout = p_dropout
        self.conv1 = nn.Conv1d(channels, 2 * channels, kernel_size, padding=kernel_size // 2)

    def forward(self, x, gen=None):
        x1, x2 = conv1d_same(x, self.conv1).chunk(2, dim=-1)
        return x + dropout(x1 * torch.sigmoid(x2), self.p_dropout, gen)


class SelfAttention(nn.Module):
    """torch.nn.MultiheadAttention(batch_first=True)'s parameters and math,
    with key_padding_mask (True = pad) filled by -finfo.max."""

    def __init__(self, embed_dim: int, num_heads: int, p_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.p_dropout = p_dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, key_padding_mask: Optional[torch.Tensor] = None, gen=None):
        b, t, c = x.shape
        d = c // self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (z.reshape(b, t, self.num_heads, d) for z in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], -torch.finfo(logits.dtype).max)
        weights = dropout(torch.softmax(logits, dim=-1), self.p_dropout, gen)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, t, c)
        return self.out_proj(out)


class MelStyleEncoder(nn.Module):
    """Mel [B, T, n_mels] -> style vector [B, style_vector_dim]."""

    def __init__(self, n_mel_channels: int = 80, style_hidden: int = 128, style_vector_dim: int = 256,
                 style_kernel_size: int = 5, style_head: int = 2, dropout: float = 0.1):
        super().__init__()
        self.p_dropout = dropout
        # the reference's layer indices (spectral.0 / .3); its Dropout slots
        # are applied in forward from the caller's generator
        self.spectral = nn.Sequential(
            nn.Linear(n_mel_channels, style_hidden), nn.Mish(), nn.Identity(),
            nn.Linear(style_hidden, style_hidden), nn.Mish(), nn.Identity(),
        )
        self.temporal = nn.ModuleList([
            Conv1dGLU(style_hidden, style_kernel_size, dropout),
            Conv1dGLU(style_hidden, style_kernel_size, dropout),
        ])
        self.slf_attn = SelfAttention(style_hidden, style_head, dropout)
        self.fc = nn.Linear(style_hidden, style_vector_dim)

    def _trunk(self, x, gen=None):
        """The spectral and temporal layers: [B, T, n_mels] -> [B, T, hidden]."""
        lin0, act, _, lin3, _, _ = self.spectral
        x = dropout(act(lin0(x)), self.p_dropout, gen)
        x = dropout(act(lin3(x)), self.p_dropout, gen)
        for glu in self.temporal:
            x = glu(x, gen)
        return x

    def forward(self, x, mask: Optional[torch.Tensor] = None, gen=None):
        """mask: [B, T] validity mask (1 = valid) or None."""
        x = self._trunk(x, gen)
        x = self.slf_attn(x, None if mask is None else mask <= 0, gen)
        x = self.fc(x)
        if mask is None:
            return x.mean(dim=1)
        m = mask.to(x.dtype)[..., None]
        return (x * m).sum(dim=1) / m.sum(dim=1)


class AttnMelStyleEncoder(MelStyleEncoder):
    """Attention-pool variant of MelStyleEncoder (same parameters): the masked
    mean of the trunk's output is prepended as a query token that every item
    may attend, and its attention output becomes the style vector. Inference
    only (no dropout); the attention core is `ops.attention.masked_attention`,
    so on the GPU it is the packed-head kernel (head width 64, as the default
    128 / 2 gives)."""

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        x = self._trunk(x)
        if mask is None:
            avg = x.mean(dim=1, keepdim=True)
            key_mask = None
        else:
            m = mask.to(x.dtype)[..., None]
            avg = ((x * m).sum(dim=1) / m.sum(dim=1))[:, None, :]
            key_mask = torch.cat([torch.ones_like(mask[:, :1]), mask], dim=1)
        x = torch.cat([avg, x], dim=1)
        b, t, c = x.shape
        attn = self.slf_attn
        q, k, v = (z.reshape(b, t, attn.num_heads, c // attn.num_heads)
                   for z in F.linear(x, attn.in_proj_weight, attn.in_proj_bias).chunk(3, dim=-1))
        out = masked_attention(q, k, v, mask=key_mask).reshape(b, t, c)
        return self.fc(attn.out_proj(out)[:, 0, :])
