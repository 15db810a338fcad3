"""STFT and log-mel spectrogram for the reference audio
(reference: utils/audio.py:6-57): reflect padding by (n_fft - hop) // 2,
center=False framing, periodic Hann window, magnitude sqrt(re^2 + im^2 + 1e-6),
slaney mel filterbank, log(clamp(mel, 1e-5)). Output is channels-last
[B, T_frames, n_mels]."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stabletts_torch.config import MelConfig


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, as torch.hann_window(periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    min_log_hz, min_log_mel, logstep = 1000.0, 15.0, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f * 3.0 / 200.0)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    min_log_hz, min_log_mel, logstep = 1000.0, 15.0, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * 200.0 / 3.0)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                   f_max: float | None = None, dtype=np.float32) -> np.ndarray:
    """[n_freqs, n_mels] slaney-scale, slaney-normalised triangular
    filterbank (torchaudio melscale_fbanks(mel_scale='slaney', norm='slaney')),
    built in float64."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).astype(dtype)


_const_cache: dict = {}


def _device_constant(key: tuple, device, make) -> torch.Tensor:
    """A constant tensor (window, filterbank) built once per key and device:
    a GAN step takes 15 log-mels, and building each filterbank on the host
    and copying it over would be paid every time."""
    key = (*key, str(device))
    if key not in _const_cache:
        _const_cache[key] = torch.from_numpy(make()).to(device)
    return _const_cache[key]


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int, pad: int) -> torch.Tensor:
    """[B, L] waveform -> [B, T, n_freqs] magnitude, T = 1 + (L + 2*pad - n_fft) // hop."""
    window = _device_constant(("hann", win_length), x.device, lambda: hann_window(win_length))
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    frames = x.unfold(-1, n_fft, hop_length) * window
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return torch.sqrt(spec.real.square() + spec.imag.square() + 1e-6)


def log_mel_spectrogram(x: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, L] float32 waveform -> [B, T, n_mels] log-mel spectrogram."""
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.pad)
    key = ("mel", cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max)
    fb = _device_constant(key, x.device,
                          lambda: mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max))
    return torch.log(torch.clamp(mag @ fb, min=1e-5))
