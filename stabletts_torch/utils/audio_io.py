"""Host-side audio IO: WAV and FLAC decode with resampling.

The port's copy of the JAX package's `utils/audio_io.py` (reference:
utils/audio.py:59-74). `load_and_resample_audio` takes the port's native
loader first (`stabletts_torch/native`: WAV and FLAC decode, windowed-sinc
resampling), as the JAX package does, and scipy's WAV reader with polyphase
resampling where the library cannot be built. `load_audio` reads WAV only:
the Python FLAC decoder and the mp3 and ogg decoders are not ported yet and
raise.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """Returns (mono float32 waveform in [-1, 1], sample_rate)."""
    # sniff by magic bytes, not extension
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic != b"RIFF":
        ext = os.path.splitext(path)[1].lower()
        raise ValueError(
            f"unsupported audio format {ext!r} (WAV, FLAC, mp3 and ogg are "
            "decodable in this environment; convert others offline): "
            "FLAC, mp3 and ogg decoding is not ported yet, only WAV is read here"
        )
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav[:, 0]  # mono via first channel (reference: utils/audio.py:68-69)
    return wav, int(sr)


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (kaiser window)."""
    if sr == target_sr:
        return wav
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(wav, target_sr // g, sr // g).astype(np.float32)


def load_and_resample_audio(path: str, target_sr: int) -> Optional[np.ndarray]:
    """Load + mono + resample; returns None on failure
    (reference: utils/audio.py:59-74 returns None on load errors).

    Uses the native C++ loader (WAV or FLAC parse + windowed-sinc resample)
    when it builds; falls back to scipy."""
    try:
        from stabletts_torch.native import load_wav_native

        result = load_wav_native(path, target_sr)
        if result is not None:
            return result[0]
    except Exception:
        pass
    try:
        wav, sr = load_audio(path)
    except Exception as e:  # noqa: BLE001 - mirrors the reference
        print(str(e))
        return None
    return resample(wav, sr, target_sr)


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))
