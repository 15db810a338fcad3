"""The Vocos ISTFT head as one CUDA kernel (csrc/istft.cu).

Replaces the JAX package's TPU kernel `ops/istft_pallas.py::istft_same_fused`
(reached through `istft_same_fused_diff`). Output row i (one hop of samples)
is sum_{j < n_fft/hop} spec[i - j] @ W[:, j*hop:(j+1)*hop] with W the windowed
iDFT matrix of `ops/istft.py`, so the [B, T, n_fft] frames never reach device
memory; the kernel then applies the envelope and writes the trimmed waveform.

Besides the static envelope (host-side, float64 sum, as the JAX package), the
kernel takes per-item `lengths`: frames past an item's length are zero and
its envelope sums over its valid frames only, which is `istft_same_real`'s
frame_mask mode for prefix masks (Vocos's fixed-shape serving mode).

`istft_head` dispatches on the tensor's device: the plain `istft_same_real`
on the CPU, the kernel on the GPU. `istft_head.launches` counts launches.
`istft_head_diff` is `istft_head` with a gradient, the counterpart of the JAX
package's `istft_same_fused_diff`: the ISTFT is linear in (re, im), so its
backward is the transpose of the plain ISTFT, in f32 whatever the forward's
`matmul_dtype` (gradient noise does not average out as forward noise does).
"""

from __future__ import annotations

import numpy as np
import torch

from stabletts_torch.ops.istft import (
    hann_window,
    idft_matrix_windowed,
    istft_same_real,
    window_envelope,
)

_env_cache: dict = {}


def _envelope_inverse(t: int, n_fft: int, hop: int, device) -> torch.Tensor:
    """1 / envelope over the untrimmed [(t + r - 1), hop] rows, f32."""
    key = (t, n_fft, hop, str(device))
    if key not in _env_cache:
        if len(_env_cache) > 32:
            _env_cache.clear()
        env = window_envelope(hann_window(n_fft), t, hop)
        inv = (1.0 / np.maximum(env, 1e-11)).astype(np.float32)
        _env_cache[key] = torch.from_numpy(inv).to(device)
    return _env_cache[key]


def _istft_cuda(re, im, n_fft, hop_length, matmul_dtype, lengths):
    from stabletts_torch.ops import _build

    b, t, nf = re.shape
    if nf != n_fft // 2 + 1 or im.shape != re.shape:
        raise ValueError(f"istft kernel: re/im must be [B, T, {n_fft // 2 + 1}]")
    if n_fft % hop_length or n_fft // hop_length > 8:
        raise ValueError(f"istft kernel needs hop | n_fft with n_fft/hop <= 8 (n_fft={n_fft}, hop={hop_length})")
    dt = torch.bfloat16 if matmul_dtype == torch.bfloat16 else torch.float32
    re = re.to(dt).contiguous()
    im = im.to(dt).contiguous()
    w = idft_matrix_windowed(n_fft, n_fft, re.device, dt)
    wsq = torch.from_numpy(hann_window(n_fft).astype(np.float64) ** 2).float().to(re.device)
    if lengths is None:
        envinv = _envelope_inverse(t, n_fft, hop_length, re.device)
        lens = torch.empty(0, dtype=torch.int32, device=re.device)
    else:
        envinv = torch.empty(0, dtype=torch.float32, device=re.device)
        lens = lengths.to(device=re.device, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError("istft kernel: lengths must be [B]")
    out = torch.empty(b, t * hop_length, device=re.device, dtype=torch.float32)
    fn = _build.load("istft", "istft_forward", 7, 6)
    err = fn(
        re.data_ptr(), im.data_ptr(), w.data_ptr(), envinv.data_ptr(), wsq.data_ptr(),
        lens.data_ptr(), out.data_ptr(),
        b, t, n_fft, hop_length, int(lengths is not None), int(dt == torch.bfloat16),
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "istft")
    istft_head.launches += 1
    return out


def istft_head(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
               matmul_dtype=None, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """re/im [B, T, n_fft//2 + 1] f32 -> waveform [B, T * hop] f32, with
    win_length == n_fft. lengths [B] (optional) is the fixed-shape mode."""
    if re.device.type == "cpu":
        frame_mask = None
        if lengths is not None:
            frame_mask = (torch.arange(re.shape[1])[None, :] < lengths[:, None]).float()
        return istft_same_real(re, im, n_fft, hop_length, n_fft, matmul_dtype, frame_mask)
    if re.device.type != "cuda":
        raise ValueError(f"istft_head runs on cpu or cuda, not {re.device}")
    return _istft_cuda(re, im, n_fft, hop_length, matmul_dtype, lengths)


istft_head.launches = 0


class _ISTFTHeadFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, re, im, n_fft, hop_length, matmul_dtype):
        ctx.meta = (n_fft, hop_length, re.shape, re.dtype, im.dtype)
        return istft_head(re.detach(), im.detach(), n_fft, hop_length, matmul_dtype)

    @staticmethod
    def backward(ctx, g):
        n_fft, hop_length, shape, re_dtype, im_dtype = ctx.meta
        # the transpose of a linear map is its vector-Jacobian product at any point
        with torch.enable_grad():
            re0 = torch.zeros(shape, device=g.device, dtype=torch.float32, requires_grad=True)
            im0 = torch.zeros(shape, device=g.device, dtype=torch.float32, requires_grad=True)
            out = istft_same_real(re0, im0, n_fft, hop_length, n_fft)
            dre, dim = torch.autograd.grad(out, (re0, im0), g.float())
        return dre.to(re_dtype), dim.to(im_dtype), None, None, None


def istft_head_diff(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
                    matmul_dtype=None) -> torch.Tensor:
    """`istft_head` (static envelope) with a gradient with respect to re and im."""
    return _ISTFTHeadFn.apply(re, im, n_fft, hop_length, matmul_dtype)
