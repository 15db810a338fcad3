"""Attention dispatch, the counterpart of the JAX package's `ops/attention.py`:

  fused  the port's packed-head kernel (`ops.attention_packed_cuda.attention`)
  flash  the JAX package's stock flash kernel has no separate port: it maps
         onto the same packed-head kernel. The JAX flash path passes the mask
         as segment ids, so a padded query attends padded keys only; those rows
         are garbage that every caller masks, in both packages, so after
         `* mask` the two agree
  xla    plain einsum + softmax with the pair bias of `attn_bias_from_mask`
  auto   `fused` for a CUDA tensor, `xla` for a CPU tensor

A full additive `bias`, or q and k of different lengths, forces `xla`, as in
the JAX package. Padded or invalid keys are excluded on every path; outputs at
padded query positions are garbage the caller masks.

Not carried over, because they exist only for the TPU kernel's tiles: the
`_FUSED_MIN_T` floor of 128 rows under `auto`, the `T % 8` gate of the blocks,
and `STABLETTS_ATTN_BLK` (the port's kernel tiles by 64 and takes any T).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from stabletts_torch.ops.attention_packed_cuda import attention

IMPLS = ("auto", "xla", "flash", "fused")

_default_impl: Optional[str] = None  # None: read STABLETTS_ATTN_IMPL at call time


def set_default_impl(impl: Optional[str]) -> None:
    """Set the process-wide default implementation ('auto' | 'xla' | 'flash'
    | 'fused'); None goes back to the STABLETTS_ATTN_IMPL variable."""
    global _default_impl
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    _default_impl = impl


def resolve_impl(impl: Optional[str], device: torch.device) -> str:
    """The implementation a call on `device` takes: `impl`, else the default
    set by `set_default_impl`, else STABLETTS_ATTN_IMPL, else 'auto'."""
    impl = impl or _default_impl or os.environ.get("STABLETTS_ATTN_IMPL", "auto")
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    return "fused" if device.type == "cuda" else "xla"


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


def masked_attention(q, k, v, mask: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Self or cross attention on [B, T, H, D] operands. Give either `mask`
    ([B, T] validity, used by every path) or a full additive `bias`
    ([B, 1, Tq, Tk], which forces the plain path)."""
    resolved = resolve_impl(impl, q.device)
    if resolved in ("fused", "flash") and bias is None and q.shape[1] == k.shape[1]:
        return attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    if bias is None and mask is not None:
        bias = attn_bias_from_mask(mask.to(q.dtype), dtype=q.dtype)
    return xla_attention(q, k, v, bias)
