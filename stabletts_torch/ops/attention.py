"""Attention dispatch, the counterpart of the JAX package's `ops/attention.py`.

`masked_attention` takes one of two paths, chosen by `route` from what the call
shows: the port's packed-head kernel (`ops.attention_packed_cuda.attention`)
for a CUDA tensor with no full additive bias and q and k of one length, else
plain einsum + softmax with the pair bias of `attn_bias_from_mask` (a CPU
tensor, a full `bias`, or cross attention). Padded or invalid keys are
excluded on both paths; outputs at padded query positions are garbage the
caller masks.

Not carried over: the JAX package's choice of implementation by argument or
variable (its `flash` path is a TPU library kernel; on the valid rows it
computes what the packed-head kernel does), and, because they exist only for
the TPU kernel's tiles, the `_FUSED_MIN_T` floor of 128 rows, the `T % 8`
gate of the blocks and `STABLETTS_ATTN_BLK` (the port's kernel tiles by 64 and
takes any T).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stabletts_torch.ops.attention_packed_cuda import attention


def route(device: torch.device, has_bias: bool, q_len: int, k_len: int) -> str:
    """The path `masked_attention` takes: "packed" (the packed-head kernel)
    on CUDA with no full bias and equal lengths of q and k, else "plain"."""
    return "packed" if device.type == "cuda" and not has_bias and q_len == k_len else "plain"


def attn_bias_from_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, T] validity mask -> additive [B, 1, T, T] bias: 0 for valid
    (query, key) pairs, -finfo(dtype).max otherwise."""
    pair = mask[:, None, :, None] * mask[:, None, None, :]
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(pair > 0, zero, torch.full_like(zero, -torch.finfo(dtype).max))


def xla_attention(q, k, v, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """q/k/v [B, T, H, D]; bias [B, 1, Tq, Tk] additive or None."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        logits = logits + bias
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def masked_attention(q, k, v, mask: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self or cross attention on [B, T, H, D] operands. Give either `mask`
    ([B, T] validity, used by both paths) or a full additive `bias`
    ([B, 1, Tq, Tk], which takes the plain path)."""
    if route(q.device, bias is not None, q.shape[1], k.shape[1]) == "packed":
        return attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    if bias is None and mask is not None:
        bias = attn_bias_from_mask(mask.to(q.dtype), dtype=q.dtype)
    return xla_attention(q, k, v, bias)
