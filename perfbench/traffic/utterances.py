"""A training corpus as preprocessing writes it: one .npy log-mel [T, n_mels]
per utterance and a JSONL filelist of {mel_path, phone, mel_length}. The
durations are the log-normal's quantiles (the same set for every seed, in a
seeded order), the mels and phoneme strings are drawn from the seed, and the
text holds one id per `frames_per_id` frames (ids = 2 x phonemes + 1)."""

from __future__ import annotations

import json
import os

import numpy as np

from perfbench.traffic.phoneme_batches import lognormal_quantiles

# the published symbol table's IPA letters (symbols 9 .. 68), without the space
PHONES = "NQabdefghijklmnopstuvwxyzɑæʃʑçɯɪɔɛɹðəɫɥɸʊɾʒθβŋɦ⁼ʰ`^#*=ˈˌ→↓↑"


def write(params: dict, seed: int, cfg: dict, out_dir: str) -> str:
    """Writes the corpus under `out_dir`; returns the filelist's path."""
    rng = np.random.default_rng([seed, 4])
    fps = cfg["sample_rate"] / cfg["hop_length"]
    s = params["seconds"]
    frames = lognormal_quantiles(params["n"], s["median"] * fps, s["sigma"], round(s["min"] * fps),
                                 round(s["max"] * fps))
    rng.shuffle(frames)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "filelist.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        for i, t in enumerate(frames):
            mel = (rng.standard_normal((int(t), cfg["n_mels"]), dtype=np.float32) * 2.0 - 5.0)
            mel_path = os.path.join(out_dir, f"{i:05d}.npy")
            np.save(mel_path, mel)
            n_ph = max(1, int(round((t / params["frames_per_id"] - 1) / 2)))
            phone = "".join(PHONES[k] for k in rng.integers(0, len(PHONES), size=n_ph))
            f.write(json.dumps({"mel_path": mel_path, "phone": phone, "mel_length": int(t)}, ensure_ascii=False) + "\n")
    return path
