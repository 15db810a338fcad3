"""Objective evaluation metrics (the reference computes none — SURVEY §5.5):
mel-cepstral distortion, log-mel L1/L2, and a simple SNR, for comparing
synthesized audio against references or across model versions. The four
metrics are numpy copies of the JAX package's `utils/eval.py`;
`evaluate_pair` computes its log-mels with the port's `ops.stft`, on the GPU
unless the caller passes "cpu"."""

from __future__ import annotations

import numpy as np


def _dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Type-II DCT basis (as used for MFCC extraction)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    return np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)


def mel_cepstral_distortion(
    mel_a: np.ndarray, mel_b: np.ndarray, n_mfcc: int = 13
) -> float:
    """MCD (dB) between two log-mel spectrograms [T, n_mels].

    Frames are truncated to the shorter sequence (no DTW); the 0th cepstral
    coefficient (energy) is excluded per convention.
    """
    t = min(mel_a.shape[0], mel_b.shape[0])
    a, b = np.asarray(mel_a[:t], np.float64), np.asarray(mel_b[:t], np.float64)
    dct = _dct_matrix(n_mfcc, a.shape[1])
    ca, cb = a @ dct.T, b @ dct.T
    diff = ca[:, 1:] - cb[:, 1:]
    return float(
        (10.0 / np.log(10.0)) * np.sqrt(2.0) * np.mean(np.sqrt(np.sum(diff ** 2, axis=1)))
    )


def mel_l1(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    t = min(mel_a.shape[0], mel_b.shape[0])
    return float(np.mean(np.abs(np.asarray(mel_a[:t]) - np.asarray(mel_b[:t]))))


def mel_l2(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    t = min(mel_a.shape[0], mel_b.shape[0])
    return float(np.sqrt(np.mean((np.asarray(mel_a[:t]) - np.asarray(mel_b[:t])) ** 2)))


def waveform_snr(ref: np.ndarray, est: np.ndarray) -> float:
    """SNR (dB) of est against ref (aligned, truncated to the shorter)."""
    n = min(len(ref), len(est))
    ref, est = np.asarray(ref[:n], np.float64), np.asarray(est[:n], np.float64)
    noise = ref - est
    denom = np.sum(noise ** 2) + 1e-12
    return float(10.0 * np.log10(np.sum(ref ** 2) / denom))


def evaluate_pair(ref_wav: np.ndarray, est_wav: np.ndarray, mel_config=None, device=None) -> dict:
    """All metrics for a (reference, estimate) waveform pair at the same rate;
    the log-mels on `device` (the GPU unless the caller passes "cpu")."""
    import torch

    from stabletts_torch.config import MelConfig
    from stabletts_torch.ops.stft import log_mel_spectrogram
    from stabletts_torch.utils.device import resolve_device

    mel_config = mel_config or MelConfig()
    dev = resolve_device(device)
    mel = lambda w: log_mel_spectrogram(torch.as_tensor(np.asarray(w, np.float32), device=dev)[None, :],
                                        mel_config)[0].cpu().numpy()
    mel_r, mel_e = mel(ref_wav), mel(est_wav)
    return {
        "mcd_db": mel_cepstral_distortion(mel_r, mel_e),
        "mel_l1": mel_l1(mel_r, mel_e),
        "mel_l2": mel_l2(mel_r, mel_e),
        "snr_db": waveform_snr(ref_wav, est_wav),
    }
