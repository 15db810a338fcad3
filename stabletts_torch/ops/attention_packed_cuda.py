"""Packed-head attention in both operand layouts: CUDA kernels
(csrc/attention_packed.cu) and their plain PyTorch versions.

    out_h = softmax(q_h k_h^T / sqrt(D) + key_bias) v_h      per head h

Replaces the JAX package's TPU kernels
`ops/attention_pallas.py::fused_attention_packed` (operands [B, T, H*D], with
its [B, T, H, D] wrapper `fused_attention`) and
`ops/attention_pallas_t.py::fused_attention_packed_t` (operands [B, H*D, T])
and keeps their numerics: q and k arrive rotated and unscaled; the f32 scores
are scaled by 1/sqrt(D); `mask` ([B, T], 1 = valid, or None for every key
valid) masks keys only, with the finite bias -0.7*f32max, so padded query rows
and items whose keys are all padded come out finite and the caller masks them
(in f32 the kernels write zeros for a tile of padded query rows in an item with
a valid key, and skip the tiles of padded keys, whose weights are exactly 0);
softmax statistics in f32, the weights rounded to v's dtype before the PV
product, the normaliser the unrounded f32 sum. The kernels take any T (ragged
tiles are masked; the TPU kernels pad to 128 instead) and head width 64.

`attention_packed`, `attention` and `attention_packed_t` dispatch on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor the
kernel (or an error). `attention_packed.launches` and
`attention_packed_t.launches` count kernel launches (`attention` counts as
`attention_packed`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stabletts_torch.ops.dit_block_cuda import _NEG


def attention_packed_plain(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """q/k/v [B, T, H*D]; mask [B, T] or None -> [B, T, H*D] in q's dtype."""
    b, t, c = q.shape
    d = c // n_heads
    qh, kh, vh = (z.reshape(b, t, n_heads, d) for z in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * (1.0 / math.sqrt(d))
    if mask is not None:
        s = s + torch.where(mask > 0, 0.0, _NEG).float()[:, None, None, :]
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", w.to(v.dtype).float(), vh.float()) / denom
    return o.permute(0, 2, 1, 3).reshape(b, t, c).to(q.dtype)


def attention_packed_t_plain(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """q/k/v [B, H*D, T]; mask [B, T] or None -> [B, H*D, T] in q's dtype."""
    out = attention_packed_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask, n_heads)
    return out.transpose(1, 2).contiguous()


def _launch(entry: str, q, k, v, mask, n_heads: int, b: int, t: int, c: int):
    from stabletts_torch.ops import _build

    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{entry} kernel takes float32 or bfloat16, got {q.dtype}")
    if c != n_heads * 64:
        raise ValueError(f"{entry} kernel needs head_dim 64 (H*D={c}, heads={n_heads})")
    for ten in (k, v):
        if ten.shape != q.shape or ten.device != q.device or ten.dtype != q.dtype:
            raise ValueError(f"{entry} kernel: q, k and v must share shape, device and dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{entry} kernel: q, k and v must be contiguous")
    mask_ptr, maskf = 0, None
    if mask is not None:
        maskf = mask.float().contiguous()
        if maskf.shape != (b, t) or maskf.device != q.device:
            raise ValueError(f"{entry} kernel: mask must be [B, T] on q's device")
        mask_ptr = maskf.data_ptr()
    out = torch.empty_like(q)
    fn = _build.load("attention_packed", f"{entry}_forward", 5, 5)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
             b, t, c, n_heads, int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    return out


def attention_packed(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """Packed-head attention on [B, T, H*D] operands, on q's device."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, mask, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention_packed runs on cpu or cuda, not {q.device}")
    b, t, c = q.shape
    out = _launch("attention_packed", q, k, v, mask, n_heads, b, t, c)
    attention_packed.launches += 1
    return out


def attention(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q/k/v [B, T, H, D] -> [B, T, H, D]: `attention_packed` on the packed
    view (the reshape moves nothing for contiguous tensors)."""
    b, t, h, d = q.shape
    out = attention_packed(q.reshape(b, t, h * d), k.reshape(b, t, h * d), v.reshape(b, t, h * d), mask, n_heads=h)
    return out.reshape(b, t, h, d)


def attention_packed_t(q, k, v, mask: Optional[torch.Tensor] = None, n_heads: int = 4) -> torch.Tensor:
    """Packed-head attention on channel-major [B, H*D, T] operands, on q's
    device; the result is channel-major too."""
    if q.device.type == "cpu":
        return attention_packed_t_plain(q, k, v, mask, n_heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention_packed_t runs on cpu or cuda, not {q.device}")
    b, c, t = q.shape
    out = _launch("attention_packed_t", q, k, v, mask, n_heads, b, t, c)
    attention_packed_t.launches += 1
    return out


attention_packed.launches = 0
attention_packed_t.launches = 0
