"""Offline preprocessing: raw audio + text filelist -> mel .npy files + JSONL
training filelist (reference: preprocess.py:54-98). The port's copy of the
JAX package's `data/preprocess.py`.

Input filelist lines: "audio_path|transcript". Mels are extracted in device
batches through the same log-mel op the training step uses
(`ops/stft.py::log_mel_spectrogram`), on the GPU unless the caller passes
device="cpu"; each batch is padded to one shape and each mel trimmed back to
its own frame count.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from stabletts_torch.config import MelConfig
from stabletts_torch.ops.stft import log_mel_spectrogram
from stabletts_torch.utils.audio_io import load_and_resample_audio
from stabletts_torch.utils.device import resolve_device


@dataclass
class DataConfig:
    """(reference: preprocess.py:19-25)."""

    input_filelist_path: str = "filelists/input.txt"
    output_filelist_path: str = "filelists/filelist.json"
    mel_output_dir: str = "./mels"
    language: str = "chinese"  # one language per run (reference: preprocess.py:24)
    batch_size: int = 16


def get_g2p(language: str) -> Callable[[str], List[str]]:
    from stabletts_torch.text.english import english_to_ipa2
    from stabletts_torch.text.japanese import japanese_to_ipa2
    from stabletts_torch.text.mandarin import chinese_to_cnm3
    from stabletts_torch.text.router import auto_g2p

    mapping = {
        "chinese": chinese_to_cnm3,
        "english": english_to_ipa2,
        "japanese": japanese_to_ipa2,
        # per-span language routing for mixed corpora (text/router.py)
        "auto": auto_g2p,
    }
    if language not in mapping:
        raise ValueError(f"unsupported language {language!r}")
    return mapping[language]


def _extract_mels_batch(wavs: List[np.ndarray], cfg: MelConfig, device: torch.device) -> List[np.ndarray]:
    """Pad a batch of waveforms to one shape, extract mels on the device, trim."""
    hop = cfg.hop_length
    lengths = [w.shape[0] for w in wavs]
    frame_counts = [1 + max(l - hop, 0) // hop for l in lengths]
    max_len = max((fc * hop + hop) for fc in frame_counts)
    batch = np.zeros((len(wavs), max_len), dtype=np.float32)
    for i, w in enumerate(wavs):
        batch[i, : w.shape[0]] = w
    with torch.no_grad():
        mels = log_mel_spectrogram(torch.from_numpy(batch).to(device), cfg).cpu().numpy()
    return [mels[i, :fc] for i, fc in enumerate(frame_counts)]


def preprocess(data_cfg: Optional[DataConfig] = None, mel_cfg: Optional[MelConfig] = None, device=None) -> int:
    """Returns the number of successfully processed utterances."""
    data_cfg = data_cfg or DataConfig()
    mel_cfg = mel_cfg or MelConfig()
    device = resolve_device(device)
    g2p = get_g2p(data_cfg.language)
    os.makedirs(data_cfg.mel_output_dir, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(data_cfg.output_filelist_path)), exist_ok=True)

    with open(data_cfg.input_filelist_path, encoding="utf-8") as f:
        lines = [line.strip().split("|", 1) for line in f if "|" in line]

    n_done = 0
    out_records = []
    pending: List[tuple] = []

    def flush():
        nonlocal n_done
        if not pending:
            return
        wavs = [p[2] for p in pending]
        mels = _extract_mels_batch(wavs, mel_cfg, device)
        for (audio_path, text, _), mel in zip(pending, mels):
            base = os.path.splitext(os.path.basename(audio_path))[0]
            mel_path = os.path.join(data_cfg.mel_output_dir, f"{base}_{n_done}.npy")
            np.save(mel_path, mel)
            try:
                phone = g2p(text)
            except Exception as e:  # per-file tolerance (reference: preprocess.py:81-82)
                print(f"g2p failed for {audio_path}: {e}")
                continue
            out_records.append(
                {
                    "mel_path": mel_path,
                    "phone": phone,
                    "audio_path": audio_path,
                    "text": text,
                    "mel_length": int(mel.shape[0]),
                }
            )
            n_done += 1
        pending.clear()

    for audio_path, text in lines:
        wav = load_and_resample_audio(audio_path, mel_cfg.sample_rate)
        if wav is None:
            continue
        pending.append((audio_path, text, wav))
        if len(pending) >= data_cfg.batch_size:
            flush()
    flush()

    with open(data_cfg.output_filelist_path, "w", encoding="utf-8") as f:
        for rec in out_records:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
    return n_done
