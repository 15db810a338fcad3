"""Vocoder training dataset: random fixed-size audio segments
(reference: vocoders/vocos/dataset.py:10-57).

The dataset yields raw audio segments; the train step computes the mel on
the device. The port's copy of the JAX package's `data/vocos_dataset.py`,
with the port's native segment loader for WAV files.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from stabletts_torch.utils.audio_io import load_and_resample_audio

VALID_EXTENSIONS = (".wav", ".ogg", ".opus", ".mp3", ".flac")


def find_audio_files(directory: str) -> List[str]:
    """Recursive scan (reference: dataset.py:47-56)."""
    out = []
    for root, _, files in os.walk(directory):
        for f in files:
            if f.lower().endswith(VALID_EXTENSIONS):
                out.append(os.path.join(root, f))
    return sorted(out)


def vocos_preprocess(directory: str, output_filelist_path: str) -> int:
    """Directory walk -> filelist txt (reference: vocoders/vocos/preprocess.py).
    Returns the number of audio files found."""
    files = find_audio_files(directory)
    os.makedirs(os.path.dirname(os.path.abspath(output_filelist_path)), exist_ok=True)
    with open(output_filelist_path, "w", encoding="utf-8") as f:
        for path in files:
            f.write(path + "\n")
    return len(files)


class VocosDataset:
    def __init__(self, filelist_path: str, segment_size: int, sample_rate: int):
        self.segment_size = segment_size
        self.sample_rate = sample_rate
        if os.path.isdir(filelist_path):
            self.filelist = find_audio_files(filelist_path)
        else:
            with open(filelist_path, "r", encoding="utf-8") as f:
                self.filelist = [line.strip() for line in f if os.path.exists(line.strip())]
        if not self.filelist:
            raise ValueError(f"no audio files found from {filelist_path}")
        self._warned: set = set()

    def __len__(self):
        return len(self.filelist)

    def get_segment(self, idx: int, rng: np.random.Generator) -> np.ndarray:
        """[segment_size] float32 random crop, zero-padded if too short.

        Fast path: the native C++ segment loader (decode + resample + crop
        without materialising the whole file on the Python side)."""
        path = self.filelist[idx]
        start_frac = float(rng.random())
        if path.lower().endswith(".wav"):
            from stabletts_torch.native import load_segment_native

            seg = load_segment_native(path, self.sample_rate, self.segment_size, start_frac)
            if seg is not None:
                return seg
        wav = load_and_resample_audio(path, self.sample_rate)
        if wav is None:
            # substitute the next decodable clip instead of training the GAN
            # on all-zero "audio"; warn once per bad file
            if path not in self._warned:
                self._warned.add(path)
                print(f"[vocos_dataset] WARNING: failed to decode {path}; substituting next clip")
            for step in range(1, len(self.filelist)):
                alt = (idx + step) % len(self.filelist)
                wav = load_and_resample_audio(self.filelist[alt], self.sample_rate)
                if wav is not None:
                    break
            else:
                raise ValueError(f"no decodable audio in filelist (first failure: {path})")
        if wav.shape[0] < self.segment_size:
            wav = np.pad(wav, (0, self.segment_size - wav.shape[0]))
        start = int(start_frac * (wav.shape[0] - self.segment_size + 1))
        return wav[start : start + self.segment_size].astype(np.float32)

    def batch(self, indices, rng: np.random.Generator) -> np.ndarray:
        return np.stack([self.get_segment(i, rng) for i in indices])
