"""Closed-loop batch job of voice-cloned generations (F5-TTS): each item is a
prompt of `prompt_s` seconds and a generation of `gen_s` seconds, both the
log-normal's quantiles over the pool's `pool_batches` x `batch` items, paired
and clipped so that prompt + generation stays within `max_total_s`. The text
is `bytes_per_s` bytes a second of speech, one id a byte, split between the
prompt's text and the text to speak; the total frames come from F5-TTS's
byte-ratio rule. The items are sorted by total length into `batch` equal
parts, and every pool batch takes one item of each part: the longest part's
items set the batches' lengths (one each), and each other part, from the
longest down, deals its items, the longest generation first, each to the
batch with the fewest generated frames per padded frame so far, so that
every batch holds about the same audio for its work. The pool is the same
for every seed; the seed orders the pool's batches (the job cycles over
them in that order) and draws the ids uniformly from the vocabulary."""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

from perfbench.reference.f5tts_ref import total_frames


def lognormal_quantiles(n: int, p: dict) -> np.ndarray:
    """n seconds at the (i + 0.5) / n quantiles of median * exp(sigma z), clipped."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(p["median"] * np.exp(p["sigma"] * z), p["min"], p["max"])


def items(params: dict, fps: float) -> list:
    """The pool's items, each {"ref_frames", "ref_bytes", "gen_bytes", "total"},
    in pool order: batch j is items j * batch ... (j + 1) * batch - 1."""
    b, pool = params["batch"], params["pool_batches"]
    n = b * pool
    fixed = np.random.default_rng(0)  # the pairing of prompts and generations: the same for every seed
    prompt = lognormal_quantiles(n, params["prompt_s"])
    gen = fixed.permutation(lognormal_quantiles(n, params["gen_s"]))
    gen = np.minimum(gen, params["max_total_s"] - prompt)
    out = []
    for ps, gs in zip(prompt, gen):
        ref = int(ps * fps)
        rb = max(1, int(round(params["bytes_per_s"] * ps)))
        gb = max(1, int(round(params["bytes_per_s"] * gs)))
        total = max(total_frames(ref, rb, gb), max(rb + gb, ref) + 1)
        out.append({"ref_frames": ref, "ref_bytes": rb, "gen_bytes": gb, "total": total})
    out.sort(key=lambda it: it["total"])
    parts = [out[k * pool:(k + 1) * pool] for k in range(b)]
    batches = [[it] for it in parts[-1]]
    gen_frames = lambda bt: sum(it["total"] - it["ref_frames"] for it in bt) / bt[0]["total"]
    for part in reversed(parts[:-1]):
        free = list(range(pool))
        for it in sorted(part, key=lambda it: it["ref_frames"] - it["total"]):
            j = min(free, key=lambda j: gen_frames(batches[j]))
            free.remove(j)
            batches[j].append(it)
    return [it for bt in batches for it in bt]


def generate(params: dict, seed: int, n_vocab: int, fps: float) -> list:
    """[{"ids": int64 [B, Tx], "x_lengths", "x_ref_lengths", "ref_frames",
    "totals": int64 [B]}] for each batch of the pool, in the seed's order."""
    rng = np.random.default_rng(seed)
    b, pool = params["batch"], params["pool_batches"]
    its = items(params, fps)
    batches = []
    for j in rng.permutation(pool):
        group = its[j * b:(j + 1) * b]
        n = np.array([g["ref_bytes"] + g["gen_bytes"] for g in group])
        ids = np.zeros((b, int(n.max())), dtype=np.int64)
        for r, k in enumerate(n):
            ids[r, :k] = rng.integers(0, n_vocab, size=k)
        batches.append({"ids": ids, "x_lengths": n, "x_ref_lengths": np.array([g["ref_bytes"] for g in group]),
                        "ref_frames": np.array([g["ref_frames"] for g in group]),
                        "totals": np.array([g["total"] for g in group]), "pool_index": int(j)})
    return batches
