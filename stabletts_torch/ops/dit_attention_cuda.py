"""The inference DiT block's attention half: CUDA kernel
(csrc/dit_attention.cu) and its plain PyTorch version.

    out = x + gate * out_proj(attn(rope(qkv(mod(LN(x)))))) * mask

Replaces the JAX package's TPU kernel
`ops/dit_attention_pallas.py::fused_dit_attention` and keeps its numerics:
LayerNorm without affine and with f32 statistics; log2(e)/sqrt(D) folded into q
before partial RoPE (rotary dim D/2, the concatenated-halves form); softmax in
exp2 with the key bias -0.7*f32max on padded keys only (padded query rows hold
finite values that `* mask` removes); the result rounded to x's dtype. The
whole-block kernel keeps this value in f32, so in bf16 the two-kernel block
differs from the one-kernel block by one rounding.

`dit_attention` dispatches on the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor the kernel (or an error).
`dit_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from stabletts_torch.ops.dit_block_cuda import attention_half_plain, rope_tables
from stabletts_torch.ops.tap_gemm_cuda import count_conv_paths


def dit_attention_plain(x, mods, mask, wqkv, bqkv, wo, bo, n_heads: int, eps: float = 1e-5):
    """x [B, T, C] (pre-masked); mods [B, 3, C] (shift, scale, gate); mask
    [B, T]; wqkv [C, 3C] (q | k | v), bqkv [3C], wo [C, C], bo [C]. Returns
    [B, T, C] in x's dtype."""
    return attention_half_plain(x, mods, mask, wqkv, bqkv, wo, bo, n_heads, eps).to(x.dtype)


def _dit_attention_cuda(x, mods, mask, wqkv, bqkv, wo, bo, n_heads: int, eps: float):
    from stabletts_torch.ops import _build

    b, t, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dit_attention kernel takes float32 or bfloat16, got {x.dtype}")
    if c != n_heads * 64:
        raise ValueError(f"dit_attention kernel needs head_dim 64 (C={c}, heads={n_heads})")
    for ten in (x, mods, wqkv, bqkv, wo, bo):
        if ten.device != x.device or ten.dtype != x.dtype or not ten.is_contiguous():
            raise ValueError("dit_attention kernel: every input must be a contiguous tensor of x's device and dtype")
    if mods.shape != (b, 3, c) or wqkv.shape != (c, 3 * c) or bqkv.shape != (3 * c,) or wo.shape != (c, c) \
            or bo.shape != (c,):
        raise ValueError("dit_attention kernel: unexpected shapes")
    maskf = mask.float().contiguous()
    if maskf.shape != (b, t) or maskf.device != x.device:
        raise ValueError("dit_attention kernel: mask must be [B, T] on x's device")
    cos, sin = rope_tables(t, 64, x.device)
    h, q, k, v, att, out = (torch.empty_like(x) for _ in range(6))
    fn = _build.load("dit_attention", "dit_attention_forward", 15, 5, 1)
    err = fn(x.data_ptr(), mods.data_ptr(), maskf.data_ptr(), cos.data_ptr(), sin.data_ptr(), wqkv.data_ptr(),
             bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), h.data_ptr(), q.data_ptr(), k.data_ptr(),
             v.data_ptr(), att.data_ptr(), out.data_ptr(),
             b, t, c, n_heads, int(x.dtype == torch.bfloat16), eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dit_attention")
    dit_attention.launches += 1
    if x.dtype == torch.bfloat16:
        count_conv_paths((h, wqkv, c, 3 * c, t), (att, wo, c, c, t))
    return out


def dit_attention(x, mods, mask, wqkv, bqkv, wo, bo, n_heads: int, eps: float = 1e-5):
    """The attention half on x's device: plain PyTorch on the CPU, the CUDA
    kernel on the GPU."""
    if x.device.type == "cpu":
        return dit_attention_plain(x, mods, mask, wqkv, bqkv, wo, bo, n_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"dit_attention runs on cpu or cuda, not {x.device}")
    return _dit_attention_cuda(x, mods, mask, wqkv, bqkv, wo, bo, n_heads, eps)


dit_attention.launches = 0
