"""Inverse STFT with "same" padding for the Vocos head, plain PyTorch
(reference: vocoders/vocos/models/head.py:5-73): per-frame inverse real DFT
(backward norm) as one matmul with a windowed iDFT matrix, overlap-add,
division by the window envelope, and a trim of (win - hop) // 2 samples at
each end."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stabletts_torch.ops.stft import hann_window


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[B, T, win] frames -> [B, (T-1)*hop + win] overlap-added signal;
    hop must divide win (chunk j of frame i lands at (i + j) * hop)."""
    b, t, win = frames.shape
    out_len = (t - 1) * hop_length + win
    r = win // hop_length
    if r * hop_length != win:
        raise ValueError(f"overlap_add needs hop | win (win={win}, hop={hop_length})")
    chunks = frames.reshape(b, t, r, hop_length)
    out = None
    for j in range(r):
        sig = chunks[:, :, j, :].reshape(b, t * hop_length)
        padded = F.pad(sig, (j * hop_length, out_len - t * hop_length - j * hop_length))
        out = padded if out is None else out + padded
    return out


def spectrum_from_logits(x: torch.Tensor) -> tuple:
    """The Vocos head's Dense output [B, T, n_fft + 2] (log-magnitude |
    phase) -> (re, im) [B, T, n_fft//2 + 1] in f32: magnitude exp(.) clipped
    at 1e2, times cos and sin of the phase."""
    mag, p = x.float().chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(mag), max=1e2)
    return mag * torch.cos(p), mag * torch.sin(p)


def window_envelope(window: np.ndarray, n_frames: int, hop_length: int) -> np.ndarray:
    """Sum of squared windows at each output sample, summed in float64 and
    returned in the window's dtype."""
    win = window.shape[0]
    env = np.zeros((n_frames - 1) * hop_length + win, dtype=np.float64)
    wsq = window.astype(np.float64) ** 2
    for i in range(n_frames):
        env[i * hop_length : i * hop_length + win] += wsq
    return env.astype(window.dtype)


_idft_cache: dict = {}


def idft_matrix_windowed(n_fft: int, win_length: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """[n_fft + 2, n_fft] matrix W with concat([re, im], -1) @ W ==
    irfft(re + i*im, n_fft) * hann_window: the hermitian-weighted (interior
    bins twice, DC and Nyquist once), windowed inverse DFT. Built on the CPU
    in f32 with the JAX package's operation order, once per
    (n_fft, win, device, dtype)."""
    key = (n_fft, win_length, str(device), dtype)
    if key not in _idft_cache:
        n_freqs = n_fft // 2 + 1
        k = torch.arange(n_freqs, dtype=torch.float32)[:, None].expand(n_freqs, n_fft)
        n = torch.arange(n_fft, dtype=torch.float32)[None, :].expand(n_freqs, n_fft)
        ang = 2.0 * np.float32(np.pi) * k * n / n_fft
        edge = (k == 0) | (k == n_freqs - 1)
        scale = torch.where(edge, 1.0, 2.0) / n_fft
        win = torch.from_numpy(hann_window(win_length))
        if win_length < n_fft:
            win = F.pad(win, (0, n_fft - win_length))
        w = torch.cat([torch.cos(ang) * scale, -torch.sin(ang) * scale], dim=0) * win[None, :]
        _idft_cache[key] = w.to(device=device, dtype=dtype).contiguous()
    return _idft_cache[key]


def istft_same_real(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                    matmul_dtype=None, frame_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Real/imag spectrogram [B, T, n_fft//2 + 1] each -> waveform [B, T * hop].

    matmul_dtype=torch.bfloat16 quantizes the product's inputs only; the sum
    stays f32. frame_mask [B, T] (1 = valid frame) is the fixed-shape serving
    mode: masked frames are zeroed and each item's envelope sums over its
    valid frames only, so the result matches the trimmed input."""
    window = hann_window(win_length)
    pad = (win_length - hop_length) // 2
    n_frames = re.shape[1]
    if frame_mask is not None:
        fm = frame_mask.float()[..., None]
        re = re * fm.to(re.dtype)
        im = im * fm.to(im.dtype)

    spec = torch.cat([re, im], dim=-1).float()
    w_mat = idft_matrix_windowed(n_fft, win_length, re.device)
    if matmul_dtype is not None and matmul_dtype != torch.float32:
        spec = spec.to(matmul_dtype).float()
        w_mat = w_mat.to(matmul_dtype).float()
    y = overlap_add(spec @ w_mat, hop_length)

    end = -pad or None  # pad == 0 (win == hop) keeps everything
    if frame_mask is not None:
        wsq = torch.from_numpy((window.astype(np.float64) ** 2).astype(np.float32)).to(re.device)
        env = overlap_add(frame_mask.float()[..., None] * wsq[None, None, :], hop_length)
        return y[:, pad:end] / torch.clamp(env[:, pad:end], min=1e-11)
    env = window_envelope(window, n_frames, hop_length)
    if not (env[pad:end] > 1e-11).all():
        raise ValueError("istft: the window violates NOLA")
    return y[:, pad:end] / torch.from_numpy(env[pad:end]).to(re.device)
