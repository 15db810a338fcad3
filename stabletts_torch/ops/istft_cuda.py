"""The Vocos ISTFT head as two CUDA kernels (csrc/istft.cu).

Replaces the JAX package's TPU kernel `ops/istft_pallas.py::istft_same_fused`
(reached through `istft_same_fused_diff`) and the elementwise lines in front
of it. Two launches a call:

1. `istft_spectrum` (the spectrum pass): the head's Dense output [B, T,
   n_fft + 2] (log-magnitude | phase), or a spectrum re / im [B, T, n_fft/2 +
   1], -> the product's operand A [B * (T + r - 1), KP] in the matmul dtype,
   r = n_fft / hop: item b's frame f at row b * (T + r - 1) + r - 1 + f, its
   first r - 1 rows and frames at or past a length zero; columns re[0 ..
   n_fft/2] | im[1 .. n_fft/2] | zeros to KP (`packed_width`), so a row is a
   whole number of 16-byte chunks. `spectrum_plain` is its plain version.
2. The product (counted on `istft_head.launches`): output row i (one hop of
   samples) is sum_{j < r} frame[i - j] @ W[:, j*hop:(j+1)*hop] with W the
   windowed iDFT matrix of `ops/istft.py` packed as A's columns
   (`packed_weight`), so the [B, T, n_fft] frames never reach device memory;
   the epilogue applies the envelope and writes the trimmed waveform.
   `product_plain` is its plain version.

Besides the static envelope (host-side, float64 sum, as the JAX package), the
kernels take per-item `lengths`: frames past an item's length are zero and
its envelope sums over its valid frames only, which is `istft_same_real`'s
frame_mask mode for prefix masks (Vocos's fixed-shape serving mode).

`istft_head` (from re / im) and `istft_head_from_logits` (from the Dense
output, the eval head's entry) dispatch on the tensor's device: the plain
chain and `istft_same_real` on the CPU, the kernels on the GPU.
`istft_head_diff` is `istft_head` with a gradient, the counterpart of the JAX
package's `istft_same_fused_diff`: the ISTFT is linear in (re, im), so its
backward is the transpose of the plain ISTFT, in f32 whatever the forward's
`matmul_dtype` (gradient noise does not average out as forward noise does).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stabletts_torch.ops.istft import (
    hann_window,
    idft_matrix_windowed,
    istft_same_real,
    overlap_add,
    spectrum_from_logits,
    window_envelope,
)

R = 4  # n_fft / hop, the taps the kernels are built for (the shipped Vocos head: 2048 / 512)

_env_cache: dict = {}
_w_cache: dict = {}


def packed_width(n_fft: int) -> int:
    """KP: the operand's columns re[0 .. n_fft/2] | im[1 .. n_fft/2], padded
    with zeros to a multiple of 8 (2056 at n_fft = 2048). im[0] is dropped:
    it meets an all-zero row of the iDFT matrix (sin 0)."""
    return -(-(n_fft + 1) // 8) * 8


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


def _window_squared(n_fft: int, device) -> torch.Tensor:
    """window^2 [n_fft] (squared in float64, as the plain frame_mask mode), f32."""
    key = ("wsq", n_fft, str(device))
    if key not in _env_cache:
        wsq = (hann_window(n_fft).astype(np.float64) ** 2).astype(np.float32)
        _env_cache[key] = torch.from_numpy(wsq).to(device)
    return _env_cache[key]


def packed_weight(n_fft: int, device, dtype) -> torch.Tensor:
    """[KP, n_fft]: the rows of the windowed iDFT matrix that meet the
    operand's columns (re rows 0 .. n_fft/2, im rows 1 .. n_fft/2), then
    zeros; in `dtype`, rounded from f32 as the plain version rounds W."""
    key = (n_fft, str(device), dtype)
    if key not in _w_cache:
        nf = n_fft // 2 + 1
        w = idft_matrix_windowed(n_fft, n_fft)
        rows = torch.cat([w[:nf], w[nf + 1:]], dim=0)
        rows = F.pad(rows, (0, 0, 0, packed_width(n_fft) - rows.shape[0]))
        _w_cache[key] = rows.to(dtype).to(device).contiguous()
    return _w_cache[key]


def _matmul_dtype(matmul_dtype) -> torch.dtype:
    if matmul_dtype is None or matmul_dtype == torch.float32:
        return torch.float32
    if matmul_dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"istft: matmul_dtype must be None, float32 or bfloat16, not {matmul_dtype}")


def frame_mask_of(lengths: torch.Tensor | None, t: int, device) -> torch.Tensor | None:
    """[B, T] 1 for frames below each item's length (None: no mask)."""
    if lengths is None:
        return None
    return (torch.arange(t, device=device)[None, :] < lengths.to(device)[:, None]).float()


def spectrum_plain(re: torch.Tensor, im: torch.Tensor, n_fft: int, matmul_dtype=None,
                   lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The spectrum pass's plain version: re / im [B, T, n_fft/2 + 1] (f32)
    -> A [B * (T + r - 1), KP] in the matmul dtype, masked frames zero (as
    `istft_same_real` zeroes them: re * mask)."""
    b, t, nf = re.shape
    dt = _matmul_dtype(matmul_dtype)
    fm = frame_mask_of(lengths, t, re.device)
    if fm is not None:
        re, im = re * fm[..., None].to(re.dtype), im * fm[..., None].to(im.dtype)
    cols = torch.cat([re.float(), im[..., 1:].float()], dim=-1)
    cols = F.pad(cols, (0, packed_width(n_fft) - cols.shape[-1], R - 1, 0))
    return cols.to(dt).reshape(b * (t + R - 1), -1)


def product_plain(a: torch.Tensor, b: int, t: int, n_fft: int, hop: int,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The product's plain version: A [B * (T + r - 1), KP] (f32 or bf16) ->
    waveform [B, T * hop] f32: the frames A @ W in f32 (bf16 operands exact in
    f32), overlap-added, divided by the envelope and trimmed, as
    `istft_same_real`."""
    w = packed_weight(n_fft, a.device, a.dtype).float()
    frames = (a.float() @ w).reshape(b, t + R - 1, n_fft)[:, R - 1:]
    y = overlap_add(frames, hop)
    pad = (n_fft - hop) // 2
    end = -pad or None
    fm = frame_mask_of(lengths, t, a.device)
    if fm is not None:
        wsq = _window_squared(n_fft, a.device)
        env = overlap_add(fm[..., None] * wsq[None, None, :], hop)
        return y[:, pad:end] / torch.clamp(env[:, pad:end], min=1e-11)
    env = window_envelope(hann_window(n_fft), t, hop)
    return y[:, pad:end] / torch.from_numpy(env[pad:end]).to(a.device)


def _check(n_fft: int, hop: int) -> None:
    if n_fft != R * hop or hop % 64:
        raise ValueError(f"istft kernel needs n_fft = {R} * hop with hop a multiple of 64 "
                         f"(n_fft={n_fft}, hop={hop})")


def _lens(lengths, b, device) -> torch.Tensor:
    if lengths is None:
        return torch.empty(0, dtype=torch.int32, device=device)
    lens = lengths.to(device=device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError("istft kernel: lengths must be [B]")
    return lens


def _spectrum_cuda(x, im, n_fft, matmul_dtype, lengths) -> torch.Tensor:
    """Launches the spectrum pass: from the Dense output x (im None) or from re = x, im."""
    from stabletts_torch.ops import _build

    b, t = x.shape[:2]
    nf = n_fft // 2 + 1
    dt = _matmul_dtype(matmul_dtype)
    if im is None:
        if x.shape[-1] != 2 * nf or x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"istft spectrum: logits must be [B, T, {2 * nf}] in float32 or bfloat16")
        x = x.contiguous()
    else:
        if x.shape[-1] != nf or im.shape != x.shape:
            raise ValueError(f"istft spectrum: re/im must be [B, T, {nf}]")
        x, im = x.float().contiguous(), im.float().contiguous()
    lens = _lens(lengths, b, x.device)
    a = torch.empty(b * (t + R - 1), packed_width(n_fft), device=x.device, dtype=dt)
    fn = _build.load("istft", "istft_spectrum", 4, 7)
    err = fn(x.data_ptr(), None if im is None else im.data_ptr(), lens.data_ptr(), a.data_ptr(),
             b, t, nf, a.shape[1], int(lengths is not None), int(x.dtype == torch.bfloat16),
             int(dt == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "istft_spectrum")
    istft_spectrum.launches += 1
    return a


def istft_spectrum(x: torch.Tensor, n_fft: int, matmul_dtype=None, lengths: torch.Tensor | None = None,
                   im: torch.Tensor | None = None) -> torch.Tensor:
    """The product's operand A [B * (T + r - 1), KP] from the head's Dense
    output x [B, T, n_fft + 2], or (with `im`) from the spectrum re = x, im
    [B, T, n_fft/2 + 1]. On the CPU the plain chain and `spectrum_plain`; on
    the GPU the spectrum kernel."""
    if x.device.type == "cpu":
        re, im = spectrum_from_logits(x) if im is None else (x, im)
        return spectrum_plain(re, im, n_fft, matmul_dtype, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"istft_spectrum runs on cpu or cuda, not {x.device}")
    return _spectrum_cuda(x, im, n_fft, matmul_dtype, lengths)


istft_spectrum.launches = 0


def istft_product(a: torch.Tensor, b: int, t: int, n_fft: int, hop_length: int,
                  lengths: torch.Tensor | None = None, tile: int = 0) -> torch.Tensor:
    """Launches the product on A [B * (T + r - 1), KP] (bf16 or f32, the
    matmul dtype) -> waveform [B, T * hop] f32. `tile` picks the f32 CTA tile
    (0: by the grid; 64 or 128), for probes."""
    from stabletts_torch.ops import _build

    if a.device.type != "cuda":
        raise ValueError(f"istft_product launches the kernel; A lies on {a.device}")
    _check(n_fft, hop_length)
    if (a.shape != (b * (t + R - 1), packed_width(n_fft)) or not a.is_contiguous()
            or a.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"istft product: A must be a contiguous [{b * (t + R - 1)}, {packed_width(n_fft)}] "
                         f"in float32 or bfloat16")
    w = packed_weight(n_fft, a.device, a.dtype)
    wsq = _window_squared(n_fft, a.device)
    lens = _lens(lengths, b, a.device)
    envinv = wsq if lengths is not None else _envelope_inverse(t, n_fft, hop_length, a.device)
    out = torch.empty(b, t * hop_length, device=a.device, dtype=torch.float32)
    fn = _build.load("istft", "istft_forward", 6, 8)
    err = fn(a.data_ptr(), w.data_ptr(), envinv.data_ptr(), wsq.data_ptr(), lens.data_ptr(), out.data_ptr(),
             b, t, n_fft, hop_length, a.shape[1], int(lengths is not None), int(a.dtype == torch.bfloat16), tile,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "istft")
    istft_head.launches += 1
    return out


def istft_head(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
               matmul_dtype=None, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """re/im [B, T, n_fft//2 + 1] f32 -> waveform [B, T * hop] f32, with
    win_length == n_fft. lengths [B] (optional) is the fixed-shape mode."""
    if re.device.type == "cpu":
        return istft_same_real(re, im, n_fft, hop_length, n_fft, matmul_dtype,
                               frame_mask_of(lengths, re.shape[1], re.device))
    if re.device.type != "cuda":
        raise ValueError(f"istft_head runs on cpu or cuda, not {re.device}")
    _check(n_fft, hop_length)
    a = _spectrum_cuda(re, im, n_fft, matmul_dtype, lengths)
    return istft_product(a, re.shape[0], re.shape[1], n_fft, hop_length, lengths)


istft_head.launches = 0


def istft_head_from_logits(x: torch.Tensor, n_fft: int, hop_length: int, matmul_dtype=None,
                           lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The head's Dense output x [B, T, n_fft + 2] (log-magnitude | phase)
    -> waveform [B, T * hop] f32: the plain chain then `istft_head` on the
    CPU, the spectrum pass then the product on the GPU."""
    if x.device.type == "cpu":
        return istft_head(*spectrum_from_logits(x), n_fft, hop_length, matmul_dtype, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"istft_head_from_logits runs on cpu or cuda, not {x.device}")
    _check(n_fft, hop_length)
    a = _spectrum_cuda(x, None, n_fft, matmul_dtype, lengths)
    return istft_product(a, x.shape[0], x.shape[1], n_fft, hop_length, lengths)


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
