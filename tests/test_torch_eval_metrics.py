"""The port's objective metrics (stabletts_torch/utils/eval.py) and training
metrics and profiling (stabletts_torch/utils/metrics.py) against the JAX
package's on the CPU."""

import glob
import json
import os

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the other parity tests)
import numpy as np
import pytest
import torch

from stabletts_torch.config import MelConfig
from stabletts_torch.utils import eval as teval
from stabletts_torch.utils import metrics as tmetrics
from stabletts_tpu.utils import eval as jeval
from stabletts_tpu.utils import metrics as jmetrics

torch.set_num_threads(2)


def _wave(seconds, seed, sr=44100):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t) + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((50 + seed, 20)).astype(np.float32)
    b = a[:48] + 0.1 * rng.standard_normal((48, 20)).astype(np.float32)
    assert teval.mel_cepstral_distortion(a, b) == jeval.mel_cepstral_distortion(a, b)
    assert teval.mel_cepstral_distortion(a, b, n_mfcc=8) == jeval.mel_cepstral_distortion(a, b, n_mfcc=8)
    assert teval.mel_l1(a, b) == jeval.mel_l1(a, b)
    assert teval.mel_l2(a, b) == jeval.mel_l2(a, b)
    w = rng.standard_normal(1000)
    e = w[:990] + 0.1 * rng.standard_normal(990)
    assert teval.waveform_snr(w, e) == jeval.waveform_snr(w, e)


@pytest.mark.parametrize("cfg", [MelConfig(), MelConfig(n_fft=256, win_length=256, hop_length=64, n_mels=20)])
def test_evaluate_pair_matches_jax(cfg):
    from stabletts_tpu.config import MelConfig as JMelConfig

    ref, est = _wave(0.5, 0), _wave(0.45, 1) * 0.8 + _wave(0.45, 0)[: int(0.45 * 44100)] * 0.2
    got = teval.evaluate_pair(ref, est, cfg, device="cpu")
    want = jeval.evaluate_pair(ref, est, JMelConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}))
    assert set(got) == set(want) == {"mcd_db", "mel_l1", "mel_l2", "snr_db"}
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-4 * abs(want[k]), (k, got[k], want[k])
    with pytest.raises(RuntimeError):  # no GPU here, and no silent move to the CPU
        teval.evaluate_pair(ref, est, cfg)


def _write(writer_cls, log_dir):
    w = writer_cls(str(log_dir))
    w.add_scalar("loss", 1.5, 0)
    w.add_scalars({"dur": 0.25, "diff": np.float32(2.0), "prior": torch.tensor(0.75)}, 1, prefix="train/")
    w.add_scalar("lr", 1e-4, 2)
    w.close()


def _tb_scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_metric_writer_matches_jax(tmp_path):
    _write(tmetrics.MetricWriter, tmp_path / "port")
    _write(jmetrics.MetricWriter, tmp_path / "jax")
    port = (tmp_path / "port" / "metrics.jsonl").read_text()
    assert port == (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert [json.loads(line) for line in port.splitlines()] == [
        {"step": 0, "loss": 1.5}, {"step": 1, "train/dur": 0.25, "train/diff": 2.0, "train/prior": 0.75},
        {"step": 2, "lr": 1e-4}]
    scalars = _tb_scalars(tmp_path / "port")
    assert scalars == _tb_scalars(tmp_path / "jax")
    assert scalars["loss"] == [(0, 1.5)] and scalars["train/prior"] == [(1, 0.75)]
    assert scalars["lr"] == [(2, float(np.float32(1e-4)))]  # TensorBoard keeps f32


def test_profile_trace_writes_a_trace_with_the_annotated_range(tmp_path):
    with tmetrics.profile_trace(str(tmp_path / "trace")) as prof:
        with tmetrics.span("test_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = glob.glob(os.path.join(tmp_path, "trace", "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "stts.test_range" for e in events)
    assert tmetrics.snapshot()["spans"]["test_range"]["calls"] == 1
    spans = glob.glob(os.path.join(tmp_path, "trace", "spans_*.jsonl"))
    assert [os.path.basename(p)[6:] for p in spans] == [os.path.basename(files[0])[6:-5] + ".jsonl"]
    with open(spans[0]) as f:
        assert [json.loads(line) for line in f] == [
            {"name": "test_range", "start_ns": r[1], "end_ns": r[2], "parent": -1, "unit": None}
            for r in tmetrics.records()]
    assert any("mm" in str(e.get("name")) for e in events)
    with tmetrics.profile_trace(None) as prof:  # no-op
        pass
    assert prof is None
