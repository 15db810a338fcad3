"""The inference DiT block's FFN half: CUDA kernel (csrc/adaln_ffn.cu) and its
plain PyTorch version.

    out = x + gate * conv2(silu(conv1(mod(LN(x)) * mask)) * mask) * mask

Replaces the JAX package's TPU kernel `ops/ffn_pallas.py::fused_adaln_ffn` and
keeps its numerics: LayerNorm without affine and with f32 statistics (eps
1e-5); k=3 convs with zero padding at both ends; the mask applied at every conv
boundary; in bf16, the modulated input, the SiLU output and the result rounded
to bf16, every product accumulated in f32.

`adaln_ffn` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the kernel (or an error). `adaln_ffn.launches` counts
kernel launches.
"""

from __future__ import annotations

import torch

from stabletts_torch.ops.dit_block_cuda import ffn_half_plain
from stabletts_torch.ops.tap_gemm_cuda import count_conv_paths


def adaln_ffn_plain(x, mods, mask, w1, b1, w2, b2, eps: float = 1e-5):
    """x [B, T, C]; mods [B, 3, C] (shift, scale, gate); mask [B, T];
    w1 [3, C, F], b1 [F], w2 [3, F, C], b2 [C]. Returns [B, T, C] in x's dtype."""
    return ffn_half_plain(x, mods, mask, w1, b1, w2, b2, x.dtype, eps)


def _adaln_ffn_cuda(x, mods, mask, w1, b1, w2, b2, eps: float):
    from stabletts_torch.ops import _build

    b, t, c = x.shape
    f = w1.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adaln_ffn kernel takes float32 or bfloat16, got {x.dtype}")
    for ten in (x, mods, w1, b1, w2, b2):
        if ten.device != x.device or ten.dtype != x.dtype or not ten.is_contiguous():
            raise ValueError("adaln_ffn kernel: every input must be a contiguous tensor of x's device and dtype")
    if mods.shape != (b, 3, c) or w1.shape != (3, c, f) or w2.shape != (3, f, c) or b1.shape != (f,) \
            or b2.shape != (c,):
        raise ValueError("adaln_ffn kernel: unexpected shapes (the kernel has 3 taps)")
    maskf = mask.float().contiguous()
    if maskf.shape != (b, t) or maskf.device != x.device:
        raise ValueError("adaln_ffn kernel: mask must be [B, T] on x's device")
    h, out = torch.empty_like(x), torch.empty_like(x)
    y = torch.empty(b, t, f, device=x.device, dtype=x.dtype)
    fn = _build.load("adaln_ffn", "adaln_ffn_forward", 10, 5, 1)
    err = fn(x.data_ptr(), mods.data_ptr(), maskf.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             b2.data_ptr(), h.data_ptr(), y.data_ptr(), out.data_ptr(),
             b, t, c, f, int(x.dtype == torch.bfloat16), eps,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "adaln_ffn")
    adaln_ffn.launches += 1
    if x.dtype == torch.bfloat16:
        count_conv_paths((h, w1, c, f, t, 3), (y, w2, f, c, t, 3))
    return out


def adaln_ffn(x, mods, mask, w1, b1, w2, b2, eps: float = 1e-5):
    """The FFN half on x's device: plain PyTorch on the CPU, the CUDA kernel
    on the GPU."""
    if x.device.type == "cpu":
        return adaln_ffn_plain(x, mods, mask, w1, b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise ValueError(f"adaln_ffn runs on cpu or cuda, not {x.device}")
    return _adaln_ffn_cuda(x, mods, mask, w1, b1, w2, b2, eps)


adaln_ffn.launches = 0
