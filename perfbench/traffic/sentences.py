"""English sentences for the API: word counts at the log-normal's quantiles,
words drawn from `words_en.txt`, the first capitalised and a full stop at the
end, the same sentences for every seed in an order shuffled by the seed; and
reference voices, synthetic clips of harmonics under a syllable-rate
envelope with a little noise, drawn from the seed."""

from __future__ import annotations

import os

import numpy as np

from perfbench.traffic.phoneme_batches import lognormal_quantiles

WORDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "words_en.txt")
TEXT_SEED = 0


def words() -> list:
    with open(WORDS_PATH, encoding="utf-8") as f:
        return [w.strip() for w in f if w.strip()]


def sentences(params: dict, seed: int) -> list:
    """The pool of `params["pool"]` sentences in arrival order: the same
    sentences for every seed (drawn once from the fixed `TEXT_SEED`, so every
    run does the same work), in an order shuffled by the seed."""
    text_rng = np.random.default_rng(TEXT_SEED)
    w = params["words"]
    counts = lognormal_quantiles(params["pool"], w["median"], w["sigma"], w["min"], w["max"])
    vocab = words()
    out = []
    for n in counts:
        ws = [vocab[i] for i in text_rng.integers(0, len(vocab), size=int(n))]
        out.append(" ".join([ws[0].capitalize()] + ws[1:]) + ".")
    order = np.random.default_rng(seed).permutation(len(out))
    return [out[i] for i in order]


def clips(params: dict, seed: int, sample_rate: int) -> list:
    """`params["clips"]["n"]` float32 waveforms of min_s .. max_s seconds."""
    c = params["clips"]
    rng = np.random.default_rng([seed, 1])
    out = []
    for _ in range(c["n"]):
        n = int(rng.uniform(c["min_s"], c["max_s"]) * sample_rate)
        t = np.arange(n) / sample_rate
        f0 = rng.uniform(90.0, 250.0) * (1.0 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        wav = sum(rng.uniform(0.2, 1.0) / h * np.sin(h * phase) for h in range(1, 7))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3.0, 6.0) * t) ** 2
        wav = 0.3 * wav * env / np.abs(wav).max() + 0.003 * rng.standard_normal(n)
        out.append(wav.astype(np.float32))
    return out
