"""The port's spans and counters (stabletts_torch/utils/metrics.py): off and
free while no profiler records; under torch.profiler each span is a `stts.*`
range with its parent, unit and self time kept in memory; an API request
that regrows shows its two `prepare` passes and its one ODE pass, with the
bits it had when the flow ran at every cap; and a traced benchmark run of every cell
reads each per-layer metric that is computed from them."""

import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stabletts_torch.api import StableTTSAPI
from stabletts_torch.models import sampler
from stabletts_torch.utils import metrics
from torch_port_utils import MEL_CFG, MODEL_CFG, VOCOS_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "perfbench", "tests"))

import pb_helpers  # noqa: E402
from perfbench.lib import core  # noqa: E402

torch.set_num_threads(2)


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_span_is_the_shared_noop():
    metrics.reset()
    a, b = metrics.span("x"), metrics.span("y", new_unit=True)
    assert a is b
    with a:
        metrics.count("c")
        metrics.count("c", torch.ones(3))
    assert metrics.snapshot() == {"spans": {}, "counters": {}, "dropped": 0}


def test_spans_under_the_profiler_nest_and_add_up():
    metrics.reset()
    with _profiled() as prof:
        for _ in range(2):
            with metrics.span("outer", new_unit=True):
                metrics.count("items", 2)
                metrics.count("frames", torch.tensor([3, 4], dtype=torch.int32))
                for _ in range(2):
                    with metrics.span("inner"):
                        torch.ones(32, 32) @ torch.ones(32, 32)
        with metrics.span("loose"):
            pass
    names = [e.name for e in prof.events()]
    assert names.count("stts.outer") == 2 and names.count("stts.inner") == 4 and "stts.loose" in names
    recs = metrics.records()
    assert [r[0] for r in recs] == ["outer", "inner", "inner", "outer", "inner", "inner", "loose"]
    assert [r[3] for r in recs] == [-1, 0, 0, -1, 3, 3, -1]  # parent index
    assert [r[4] for r in recs] == [0, 0, 0, 1, 1, 1, None]  # unit: one a new_unit span
    snap = metrics.snapshot()
    assert snap["counters"] == {"items": 4, "frames": 14} and snap["dropped"] == 0
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["calls"] == 2 and inner["calls"] == 4 and inner["self_ns"] == inner["total_ns"]
    assert outer["self_ns"] + inner["total_ns"] == outer["total_ns"] and outer["self_ns"] > 0
    metrics.reset()
    assert metrics.snapshot() == {"spans": {}, "counters": {}, "dropped": 0}


def test_store_is_capped_and_threads_nest_their_own_spans():
    """The profiler records on its own thread only: there spans nest and fill
    the capped store; another thread's span is the shared no-op and its count
    is dropped, so nothing of it lands among the profiler thread's spans."""
    metrics.TRACER.capacity = 3
    try:
        metrics.reset()
        seen = {}

        def other():
            seen["span"] = metrics.span("b")
            with seen["span"]:
                metrics.count("other")

        with _profiled():
            with metrics.span("a", new_unit=True):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=10)
                with metrics.span("c"):
                    metrics.count("v", torch.ones(2))
                metrics.count("w", torch.ones(2))  # past the cap
                with metrics.span("d"):  # past the cap
                    pass
        assert not t.is_alive() and seen["span"] is metrics.span("x")
        recs = metrics.records()
        assert [r[0] for r in recs] == ["a", "c"]
        assert [r[3] for r in recs] == [-1, 0] and [r[4] for r in recs] == [0, 0]
        snap = metrics.snapshot()
        assert snap["dropped"] == 2 and snap["counters"] == {"v": 2}
        assert snap["spans"]["a"]["calls"] == 1 and "b" not in snap["spans"] and "d" not in snap["spans"]
    finally:
        metrics.TRACER.capacity = metrics.CAPACITY
        metrics.reset()


@pytest.fixture(scope="module")
def api():
    return StableTTSAPI(model_config=MODEL_CFG, mel_config=MEL_CFG, vocos_config=VOCOS_CFG, max_mel_len=256,
                        device="cpu")


def _wave(seconds=1.0, sr=44100):
    tt = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32)


def test_a_regrown_request_shows_both_passes(api, caplog):
    """A request past its cap shows both passes of `prepare`, at the cap and
    at twice it, and one ODE pass, at twice the cap."""
    text, ref, steps = "The quick brown fox jumps over the lazy dog.", _wave(), 2
    kw = dict(step=steps, cfg=1.0, seed=3)
    _, mel = api.inference(text, ref, "english", max_mel_len=4096, **kw)
    frames = mel.shape[2]
    cap = (frames + 1) // 2  # one regrow: cap < frames <= 2 cap
    assert cap < frames <= 2 * cap
    wav_off, mel_off = api.inference(text, ref, "english", max_mel_len=cap, **kw)
    metrics.reset()
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="stabletts_torch.api"), _profiled():
        wav_on, mel_on = api.inference(text, ref, "english", max_mel_len=cap, **kw)
    np.testing.assert_array_equal(wav_on, wav_off)  # tracing changes no result
    np.testing.assert_array_equal(mel_on, mel_off)
    assert [r.getMessage() for r in caplog.records] == [
        f"predicted length exceeded the mel cap; regrowing to {2 * cap}"]
    snap = metrics.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    assert counters["api.requests"] == 1
    assert set(counters) == {"api.requests", "sampler.frames_valid", "sampler.groups", "sampler.frames_computed"}
    # api.synthesise is the whole regrow loop: one a request
    once = ("api.request", "api.g2p", "api.ref_mel", "api.synthesise", "sampler.ode", "api.vocode", "api.to_host",
            "vocoder", "vocoder.istft_head")
    assert {k: spans[k]["calls"] for k in once} == dict.fromkeys(once, 1)
    for name in ("sampler.prepare", "text_encoder", "duration_predictor"):
        assert spans[name]["calls"] == 2, name
    assert spans["ode.step"]["calls"] == steps
    round_up = lambda n: -(-n // 256) * 256
    assert counters["sampler.groups"] == 1  # one item: one group at its own frames
    # the ODE's pass alone: the item and the frame past it, rounded up
    assert counters["sampler.frames_computed"] == min(round_up(frames + 1), round_up(2 * cap))
    assert counters["sampler.frames_valid"] == frames
    recs = metrics.records()
    assert {r[4] for r in recs} == {0}  # every span belongs to the one request
    by_index = {i: r for i, r in enumerate(recs)}
    parents = {r[0]: by_index[r[3]][0] for r in recs if r[3] >= 0}
    assert parents["api.synthesise"] == "api.request" and parents["sampler.ode"] == "api.synthesise"
    assert parents["sampler.prepare"] == "api.synthesise"
    assert parents["ode.step"] == "sampler.ode" and parents["text_encoder"] == "sampler.prepare"
    assert parents["vocoder.istft_head"] == "vocoder" and parents["vocoder"] == "api.vocode"


LONG = "The quick brown fox jumps over the lazy dog, and then it runs all the way back home again."
BATCH = [("Hi.", "english"), (LONG, "english"), ("A short line.", "english")]


def _frames(api, case, kw):
    """Each item's frames at a cap no item reaches."""
    if case == "batch":
        hop = api.mel_config.hop_length
        return [len(w) // hop for w in api.batch_inference(BATCH, _wave(), max_mel_len=1024, **kw)]
    return [api.inference(LONG, _wave(), "english", max_mel_len=1024, **kw)[1].shape[2]]


def _as_the_parent_returned(api, case, cap, kw):
    """What the regrow loop returned before it settled the cap ahead of the
    flow: `synthesise` at the final cap with the noise drawn there, then the
    vocoder."""
    from stabletts_torch.models.sampler import synthesise

    id_lists = [api._phonemes(t, lang) for t, lang in (BATCH if case == "batch" else [(LONG, "english")])]
    x = np.zeros((len(id_lists), max(map(len, id_lists))), dtype=np.int64)
    for i, ids in enumerate(id_lists):
        x[i, : len(ids)] = ids
    ref_mel, _ = api._reference_mel(_wave())
    ref_mel = ref_mel.expand(len(id_lists), -1, -1)
    out = synthesise(api.tts_model, torch.from_numpy(x), torch.tensor([len(i) for i in id_lists]),
                     api._noise(len(id_lists), cap, kw["seed"]), ref_mel, n_timesteps=kw["step"], cfg=kw["cfg"],
                     max_mel_len=cap, device="cpu")
    mel, lengths = out["decoder_outputs"], out["y_lengths"]
    if case == "batch":
        hop = api.mel_config.hop_length
        audio = api.vocoder_model(mel, lengths).numpy()
        return [audio[i, : int(lengths[i]) * hop] for i in range(len(id_lists))]
    y_len = int(lengths[0])
    return api.vocoder_model(mel[:, :y_len]).numpy(), mel[:, :y_len].numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("case,regrows", [("under", 0), ("once", 1), ("twice", 2), ("batch", 1)])
def test_the_cap_is_settled_before_the_one_ode_pass(api, caplog, case, regrows):
    """The regrow loop doubles the cap on the predicted lengths alone and runs
    the flow once, returning the bits the loop returned when it ran the flow
    at every cap it tried. "batch": three items, only one past the cap."""
    kw = dict(step=2, cfg=1.0, seed=5)
    frames = _frames(api, case, kw)
    longest = max(frames)
    if case == "batch":
        cap = max(sorted(frames)[-2], -(-longest // 2))
    else:
        cap = {"under": longest, "once": -(-longest // 2), "twice": -(-longest // 4)}[case]
    final = cap << regrows
    assert final >= longest and (regrows == 0 or final // 2 < longest)
    want = _as_the_parent_returned(api, case, final, kw)
    metrics.reset()
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="stabletts_torch.api"), _profiled():
        if case == "batch":
            got = api.batch_inference(BATCH, _wave(), max_mel_len=cap, **kw)
        else:
            got = api.inference(LONG, _wave(), "english", max_mel_len=cap, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [r.getMessage() for r in caplog.records] == [
        f"predicted length exceeded the mel cap; regrowing to {cap << i}" for i in range(1, regrows + 1)]
    snap = metrics.snapshot()
    spans = {k: v["calls"] for k, v in snap["spans"].items()}
    assert spans["sampler.prepare"] == spans["text_encoder"] == 1 + regrows
    groups = sampler.length_groups(frames, 256, -(-final // 256) * 256)
    assert spans["sampler.ode"] == spans["api.synthesise"] == 1 and spans["ode.step"] == kw["step"] * len(groups)
    assert snap["counters"]["sampler.groups"] == len(groups)
    assert snap["counters"]["sampler.frames_computed"] == sum(len(rows) * n for rows, n in groups)
    assert snap["counters"]["sampler.frames_valid"] == sum(frames)


@pytest.mark.parametrize("lengths", [None, (7, 2)])
def test_one_ffgan_vocode_opens_three_spans(lengths):
    """FireflyGAN opens `vocoder` with `ffgan.backbone` and `ffgan.head`
    inside it and none inside those (the benchmark's module ranges are the
    innermost), and counts the valid and the computed frames once; with no
    profiler nothing is kept."""
    from stabletts_torch.models.ffgan import FireflyGANBase

    model = FireflyGANBase(device="cpu").eval()
    mel = torch.randn(2, 7, 128)
    args = () if lengths is None else (torch.tensor(lengths),)
    metrics.reset()
    model(mel, *args)
    assert metrics.snapshot() == {"spans": {}, "counters": {}, "dropped": 0}
    with _profiled():
        model(mel, *args)
    snap = metrics.snapshot()
    assert {k: v["calls"] for k, v in snap["spans"].items()} == {"vocoder": 1, "ffgan.backbone": 1, "ffgan.head": 1}
    assert snap["counters"] == {"vocoder.frames_valid": 14 if lengths is None else 9, "vocoder.frames_computed": 14}
    recs = metrics.records()
    assert [(r[0], recs[r[3]][0] if r[3] >= 0 else None) for r in recs] == [
        ("vocoder", None), ("ffgan.backbone", "vocoder"), ("ffgan.head", "vocoder")]


def test_one_api_batch_with_ffgan(tmp_path):
    """An API batch through FireflyGAN (3 items, 2 steps, cap 64 that none
    reaches): 15 + 2 g spans for g length groups (a `api.g2p` an item, an
    `ode.step` a step of each group), the vocoder's three among them under
    `api.vocode`, and the vocoder's counters at the batch's lengths and its
    cap."""
    from stabletts_torch.models.ffgan import FireflyGANBase

    path = str(tmp_path / "ffgan.pt")
    torch.save(FireflyGANBase(device="cpu").state_dict(), path)
    api = StableTTSAPI(vocoder_model_path=path, vocoder_name="ffgan", model_config=MODEL_CFG, max_mel_len=64,
                       device="cpu")
    items = [("Hi.", "english"), ("Good day.", "english"), ("Yes.", "english")]
    metrics.reset()
    with _profiled():
        wavs = api.batch_inference(items, _wave(0.5), step=2, cfg=1.0)
    snap = metrics.snapshot()
    frames = [len(w) // 512 for w in wavs]
    groups = len(sampler.length_groups(frames, 256, 256))
    once = ("api.request", "api.ref_mel", "api.synthesise", "sampler.prepare", "text_encoder", "duration_predictor",
            "sampler.ode", "api.vocode", "vocoder", "ffgan.backbone", "ffgan.head", "api.to_host")
    assert {k: v["calls"] for k, v in snap["spans"].items()} == {**dict.fromkeys(once, 1), "api.g2p": 3,
                                                                 "ode.step": 2 * groups}
    assert snap["counters"]["vocoder.frames_valid"] == sum(frames) and max(frames) < 64
    assert snap["counters"]["vocoder.frames_computed"] == 3 * 64
    recs = metrics.records()
    assert {recs[r[3]][0] for r in recs if r[0] == "vocoder"} == {"api.vocode"}


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    return pb_helpers.tiny_copy(tmp_path_factory.mktemp("tracing"), pb_helpers.TINY_TRAFFIC)


NEW_METRICS = {
    "serve_batch_bf16": ["estimator_padding_share.serve"],
    "serve_api_batch_f32": ["estimator_padding_share.serve"],
    "serve_request_f32": ["ode_passes.request", "frontend_ms.request", "ode_step_host_ms.request"],
    "train_f32_b32": ["update_ms.train", "feed_wait_ms.train"],
}


@pytest.mark.parametrize("cell", sorted(NEW_METRICS))
def test_traced_run_reads_the_program_metrics(bench_root, cell):
    run = core.load_module(os.path.join(bench_root, "perfbench", "run.py"), "pb_run_tracing")
    metrics.reset()
    res = run.run(core.Cell(cell, bench_root), 2000000123, 0.5, True, "cpu")
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW_METRICS[cell]:
        assert isinstance(got.get(name), float) and got[name] >= 0.0, (name, got)
    if cell == "serve_request_f32":
        # one ODE pass a request, whether or not its cap doubled
        assert got["ode_passes.request"] == 1.0 and isinstance(got.get("regrow_share.request"), float)
        assert got["frontend_ms.request"] > 0 and got["ode_step_host_ms.request"] > 0
    elif cell == "train_f32_b32":
        assert 0.0 < got["feed_wait_ms.train"] <= got["data_wait_ms.train"] and got["update_ms.train"] > 0
    else:
        assert got["estimator_padding_share.serve"] == pytest.approx(got["padding_share.serve"], abs=1e-9)
    assert metrics.snapshot()["dropped"] == 0


def test_readers_find_nothing_in_a_program_without_spans(monkeypatch):
    """A program that keeps no spans (no `snapshot`): each reader returns None."""
    monkeypatch.delattr(metrics, "snapshot")
    for names in NEW_METRICS.values():
        for name in names:
            reader = core.load_module(os.path.join(core.PKG_DIR, "metrics", f"{name}.py"), "pb_tracing_" + name)
            assert reader.read({}) is None, name
