"""The Vocos ConvNeXt block as CUDA kernels (csrc/convnext.cu: a
depthwise-conv + LayerNorm kernel and two tap-GEMM products, on the tensor
cores in bf16 and on the FP32 pipes in f32) and its plain PyTorch version:

    h = dwconv_k7(x)                   # depthwise, SAME zero padding
    h = LN(h) * ln_w + ln_b            # f32 statistics, eps 1e-6
    y = gelu(h @ W1 + b1)              # erf form at f32, tanh form at bf16
    out = x + gamma * (y @ W2 + b2)

Replaces the JAX package's TPU kernel `ops/convnext_pallas.py::fused_convnext_block`.
h and y go through device memory between the three launches, rounded to
x's dtype where the TPU kernel rounds them; every product accumulates in f32.

`convnext_block` dispatches on the tensor's device: the plain version on the
CPU, the kernel on the GPU. `convnext_block.launches` counts
calls of the kernel route (one per block, whatever its launches).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from stabletts_torch.ops.tap_gemm_cuda import count_conv_paths


class ConvNeXtWeights(NamedTuple):
    """Kernel-layout weights of one block (see `models.vocos.ConvNeXtBlock`)."""

    dw_w: torch.Tensor   # [7, C]
    dw_b: torch.Tensor   # [C]
    ln_w: torch.Tensor   # [C]
    ln_b: torch.Tensor   # [C]
    w1: torch.Tensor     # [C, F]
    b1: torch.Tensor     # [F]
    w2: torch.Tensor     # [F, C]
    b2: torch.Tensor     # [C]
    gamma: torch.Tensor  # [C]


def dwconv_ln_plain(x: torch.Tensor, w: ConvNeXtWeights, eps: float = 1e-6) -> torch.Tensor:
    """The first of the kernel route's three stages (`dwconv_ln_kernel`):
    x [B, T, C] -> h = LN(dwconv_k7(x)) * ln_w + ln_b, rounded to x's dtype."""
    xf = x.float()
    dw = w.dw_w.float()
    t = x.shape[1]
    xp = F.pad(xf, (0, 0, 3, 3))  # row t + 3 of xp is x[t]
    h = xf * dw[3]
    for d in range(1, 4):
        h = h + xp[:, 3 - d : 3 - d + t] * dw[3 - d] + xp[:, 3 + d : 3 + d + t] * dw[3 + d]
    h = h + w.dw_b.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = (h - mu).square().mean(dim=-1, keepdim=True)
    return ((h - mu) * torch.rsqrt(var + eps) * w.ln_w.float() + w.ln_b.float()).to(x.dtype)


def convnext_block_plain(x: torch.Tensor, w: ConvNeXtWeights, eps: float = 1e-6) -> torch.Tensor:
    """x [B, T, C] -> [B, T, C] in x's dtype."""
    dt = x.dtype
    xf = x.float()
    h = dwconv_ln_plain(x, w, eps)
    y = h.float() @ w.w1.float() + w.b1.float()
    y = F.gelu(y, approximate="tanh" if dt == torch.bfloat16 else "none").to(dt)
    z = (y.float() @ w.w2.float() + w.b2.float()) * w.gamma.float()
    return (xf + z).to(dt)


def _convnext_cuda(x: torch.Tensor, w: ConvNeXtWeights, eps: float) -> torch.Tensor:
    from stabletts_torch.ops import _build

    b, t, c = x.shape
    f = w.w1.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"convnext kernel takes float32 or bfloat16, got {x.dtype}")
    if c not in (256, 512, 768):
        raise ValueError(f"convnext kernel needs C in (256, 512, 768) (C={c})")
    for ten in (x, *w):
        if ten.device != x.device or ten.dtype != x.dtype or not ten.is_contiguous():
            raise ValueError("convnext kernel: every input must be a contiguous tensor of x's device and dtype")
    if w.dw_w.shape != (7, c) or w.w1.shape != (c, f) or w.w2.shape != (f, c):
        raise ValueError("convnext kernel: unexpected weight shapes")
    out = torch.empty_like(x)
    # h [B*T, C] and y [B*T, F] between the three launches
    h = torch.empty(b * t * c, device=x.device, dtype=x.dtype)
    y = torch.empty(b * t * f, device=x.device, dtype=x.dtype)
    fn = _build.load("convnext", "convnext_forward", 13, 5, 1)
    err = fn(
        x.data_ptr(), *(ten.data_ptr() for ten in w), out.data_ptr(), h.data_ptr(), y.data_ptr(),
        b, t, c, f, int(x.dtype == torch.bfloat16), eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "convnext")
    convnext_block.launches += 1
    if x.dtype == torch.bfloat16:
        count_conv_paths((h, w.w1, c, f, t), (y, w.w2, f, c, t))
    return out


def convnext_block(x: torch.Tensor, w: ConvNeXtWeights, eps: float = 1e-6) -> torch.Tensor:
    """The ConvNeXt block on x's device: plain PyTorch on the CPU, the CUDA
    kernel on the GPU."""
    if x.device.type == "cpu":
        return convnext_block_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block runs on cpu or cuda, not {x.device}")
    return _convnext_cuda(x, w, eps)


convnext_block.launches = 0
