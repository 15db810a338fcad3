"""Percentiles and rates over a whole window."""

import statistics

import numpy as np
import pytest

import pb_helpers  # noqa: F401
from perfbench.lib import core
from perfbench.lib.readers import idle_share, mfu, padding_share


@pytest.mark.parametrize("n", [1, 2, 7, 200, 401])
def test_percentile_is_numpy_linear(n):
    xs = list(np.random.default_rng(n).lognormal(3.0, 0.7, size=n))
    for pct in (50, 95):
        assert core.percentile(xs, pct) == pytest.approx(float(np.percentile(xs, pct)), rel=1e-12)


def test_percentile_takes_every_sample():
    xs = [1.0] * 95 + [100.0] * 5
    assert core.percentile(xs, 50) == 1.0
    assert core.percentile(xs, 95) == pytest.approx(5.95)


def test_quartile_spread_uses_python_quantiles():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert core.quartile_spread(xs) == pytest.approx((q3 - q1) / q2)


def test_rate_is_over_all_work_and_time(tmp_path):
    """serve_audio_s_per_s: every batch completed, each item's own frames,
    over the whole window."""
    from perfbench.lib.core import load_module

    mod = load_module(f"{core.PKG_DIR}/entries/synthesise_vocos.py", "pb_test_entry")
    d = mod.Driver.__new__(mod.Driver)
    d.cfg = {"hop_length": 512, "sample_rate": 44100}
    d.done = [(0, np.array([100, 200])), (1, np.array([300]))]
    assert d.end_to_end(2.0)["serve_audio_s_per_s"] == pytest.approx(600 * 512 / 44100 / 2.0)


def test_readers():
    ctx = {"trace": {"busy_s": 1.5, "window_s": 2.0, "ranges_s": {"x": 0.5}, "ops": 10},
           "work": {"flops": 67e12, "dtype": "float32", "least_s": {"x": 0.1}, "valid_frames": 25,
                    "estimator_frames": 100}, "window_s": 2.0}
    assert idle_share(ctx) == pytest.approx(25.0)
    assert mfu(ctx) == pytest.approx(50.0)
    assert padding_share(ctx) == pytest.approx(75.0)
    ctx["trace"]["busy_s"] = 0.0
    assert idle_share(ctx) is None


def test_open_loop_latency_counts_the_wait():
    """Requests due every 50 ms, each served in 80 ms: the n-th waits
    n x 30 ms, and its latency runs from when it was due."""
    import time
    import types

    from perfbench.lib.core import load_module

    mod = load_module(f"{core.PKG_DIR}/entries/api_inference.py", "pb_test_api_entry")
    d = mod.Driver.__new__(mod.Driver)
    d.wl = {"traffic": {"rate_per_s": 20.0}}
    d.sentences, d.clip_of, d.clips, d.keep = ["A b."] * 8, [0] * 8, [None], set()
    d.regrow = types.SimpleNamespace(count=0)
    d.call_kwargs = lambda: {}
    fake_mel = np.zeros((1, 128, 10), np.float32)

    def inference(*a, **k):
        time.sleep(0.08)
        return np.zeros((1, 5120), np.float32), fake_mel

    d.api = types.SimpleNamespace(inference=inference)
    d.lat, d.done, d.samples, d.n = [], [], {}, 0
    d.begin(0.2)
    t0 = time.time()
    while time.time() - t0 < 0.2:
        d.step()
    d.finish()
    assert len(d.lat) == 4  # due at 0, 50, 100, 150 ms
    for n, (lat, wait) in enumerate(zip(d.lat, d.waits)):
        assert wait == pytest.approx(0.03 * n, abs=0.015)
        assert lat == pytest.approx(0.08 + 0.03 * n, abs=0.015)
    assert d.window_info()["backlog_growth"] > 1.0
