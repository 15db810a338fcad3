"""The traffic generators: deterministic per seed, the same set of sizes for
every seed, and the length distributions the workload files ask for."""

import numpy as np
import pytest

import pb_helpers  # noqa: F401  (puts the repository on sys.path)
from perfbench.lib import core
from perfbench.traffic import phoneme_batches, sentences
from perfbench.reference import text_en

SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 33 + 5]


def _params(cell):
    return core.load_json(f"{core.PKG_DIR}/workloads/{cell}.json")["traffic"]


@pytest.mark.parametrize("seed", SEEDS)
def test_phoneme_batches_deterministic(seed):
    p = _params("serve_batch_bf16")
    a, b = phoneme_batches.generate(p, seed, 401), phoneme_batches.generate(p, seed, 401)
    assert all(np.array_equal(x["ids"], y["ids"]) and np.array_equal(x["x_lengths"], y["x_lengths"])
               for x, y in zip(a, b))


def test_phoneme_batches_same_sizes_every_seed():
    p = _params("serve_batch_bf16")
    sets = [np.sort(np.concatenate([b["x_lengths"] for b in phoneme_batches.generate(p, s, 401)])) for s in SEEDS]
    assert all(np.array_equal(sets[0], s) for s in sets[1:])
    orders = [np.concatenate([b["x_lengths"] for b in phoneme_batches.generate(p, s, 401)]) for s in SEEDS[:2]]
    assert not np.array_equal(*orders)


def test_phoneme_batches_distribution():
    p = _params("serve_batch_bf16")
    batches = phoneme_batches.generate(p, 3, 401)
    lengths = np.concatenate([b["x_lengths"] for b in batches])
    t = p["text_ids"]
    assert len(batches) == p["pool_batches"] and all(b["ids"].shape[0] == p["batch"] for b in batches)
    assert lengths.min() >= t["min"] - 1 and lengths.max() <= t["max"]
    assert np.all(lengths % 2 == 1)
    assert abs(np.median(lengths) - t["median"]) <= 2
    log_sd = np.log(lengths).std()
    assert 0.8 * t["sigma"] < log_sd < 1.1 * t["sigma"]
    for b in batches:  # blanks between phonemes, zeros past each length
        for row, n in zip(b["ids"], b["x_lengths"]):
            assert np.all(row[0:n:2] == 0) and np.all(row[1:n:2] > 0) and np.all(row[n:] == 0)


@pytest.mark.parametrize("cell", ["serve_request_f32", "serve_api_batch_f32"])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_sentences_deterministic_and_bounded(cell, seed):
    p = _params(cell)
    a, b = sentences.sentences(p, seed), sentences.sentences(p, seed)
    assert a == b and len(a) == p["pool"]
    counts = [len(s.split(" ")) for s in a]
    assert min(counts) >= p["words"]["min"] and max(counts) <= p["words"]["max"]
    assert sorted(a) == sorted(sentences.sentences(p, seed + 1)) and a != sentences.sentences(p, seed + 1)
    assert all(s.endswith(".") and s[0].isupper() for s in a)
    vocab = set(sentences.words())
    assert all(w.lower() in vocab for s in a for w in s.rstrip(".").split(" "))


def test_sentence_lengths_stay_under_the_doubled_cap():
    """At about 3.3 frames an id, no request passes 2048 frames, and the
    share past 1024 (the API's regrow) is what PERF.md records."""
    p = _params("serve_request_f32")
    ids = np.array([len(text_en.sentence_ids(s)) for s in sentences.sentences(p, 5)])
    assert ids.max() * 3.6 < 2048
    assert 0.1 < np.mean(ids * 3.3 > 1024) < 0.3


def test_clips_deterministic_and_sized():
    p = _params("serve_request_f32")
    a, b = sentences.clips(p, 9, 44100), sentences.clips(p, 9, 44100)
    assert len(a) == p["clips"]["n"] and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(p["clips"]["min_s"] * 44100 <= len(x) <= p["clips"]["max_s"] * 44100 for x in a)
    assert all(np.abs(x).max() < 1.0 and x.dtype == np.float32 for x in a)
