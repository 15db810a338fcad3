"""The sampler's length groups (stabletts_torch/models/sampler.py): `sample`
sorts a batch by its lengths and runs one ODE pass per group at the group's
own frames. On the CPU, for StableTTS and for F5-TTS at a small width, the
grouped result equals one pass at the model's frames item by item (f32: the
order of the sums alone), the frames past each length hold the initial
noise, the outputs keep the input order, and the partition counts the
fewest frames of those `length_groups` may choose."""

import itertools
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stabletts_torch.config import F5Config
from stabletts_torch.models import build_stabletts, sampler
from stabletts_torch.models.f5tts import F5TTS
from stabletts_torch.utils import metrics

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_utils import MEL_CFG, MODEL_CFG  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5  # f32 on both sides: the estimator's sums over other frame counts
F5_CFG = F5Config(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=64, text_num_embeds=40, conv_layers=1,
                  mel_dim=20)
# text lengths whose durations fall in three multiples of 256 frames at length_scale 4
X_LENGTHS = [60, 12, 100, 35, 80]
LENGTHS = [336, 84, 608, 176, 444]


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _one_pass(lengths, quantum, max_frames, *_):
    """The partition of a pass at the model's frames: every item in one group."""
    return [(list(range(len(lengths))), max_frames)]


@pytest.fixture(scope="module")
def stabletts():
    torch.manual_seed(0)
    model = build_stabletts(MODEL_CFG, MEL_CFG, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # adaLN and the CFG embeddings off their zeros, so every branch does work
        for name, p in model.named_parameters():
            if "adaLN_modulation" in name or name in ("fake_speaker", "fake_content"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return model


def _stabletts_batch(perm, seed=2):
    g = torch.Generator().manual_seed(seed)
    xl = torch.tensor([X_LENGTHS[i] for i in perm])
    x = torch.randint(1, 100, (len(perm), max(X_LENGTHS)), generator=torch.Generator().manual_seed(5))[list(perm)]
    x = x * (torch.arange(x.shape[1])[None] < xl[:, None])
    y_ref = torch.randn(1, 40, MEL_CFG.n_mels, generator=g).expand(len(perm), -1, -1)
    noise = torch.randn(len(X_LENGTHS), 1000, MEL_CFG.n_mels, generator=g)[list(perm)]
    return x, xl, y_ref, noise


def _stabletts_run(model, perm, cfg, solver="euler", steps=3):
    x, xl, y_ref, noise = _stabletts_batch(perm)
    prep = sampler.prepare(model, x, xl, y_ref, 1000, 4.0, device="cpu")
    out = sampler.sample(model, prep, noise, steps, 0.8, solver, cfg, device="cpu")
    return out, noise


@pytest.mark.parametrize("cfg", [3.0, 1.0])
@pytest.mark.parametrize("perm", [(0, 1, 2, 3, 4), (2, 4, 0, 3, 1), (1, 3, 0, 4, 2)])
def test_stabletts_groups_equal_one_pass(stabletts, monkeypatch, cfg, perm):
    """Grouped against one pass at the cap's 1024 frames, item by item, for
    three orders of the same lengths; the frames past each length are the
    noise times the temperature to the bit; the text side is unchanged."""
    got, noise = _stabletts_run(stabletts, perm, cfg)
    lengths = got["y_lengths"].tolist()
    groups = sampler.length_groups(lengths, 256, 1024)
    assert len(groups) > 1 and max(f for _, f in groups) < 1024  # the batch does split and skip frames
    with monkeypatch.context() as m:
        m.setattr(sampler, "length_groups", _one_pass)
        want, _ = _stabletts_run(stabletts, perm, cfg)
    for key in ("y_lengths", "y_clamped", "attn", "encoder_outputs", "y_mask"):
        assert torch.equal(got[key], want[key]), key
    assert lengths == [LENGTHS[i] for i in perm]  # the input order
    for r, n in enumerate(lengths):
        assert _rel(got["decoder_outputs"][r, :n], want["decoder_outputs"][r, :n]) < TOL
        assert torch.equal(got["decoder_outputs"][r, n:], noise[r, n:] * 0.8)
        assert torch.equal(want["decoder_outputs"][r, n:], noise[r, n:] * 0.8)


def _f5_batch(specs, seed=3):
    """specs: (prompt frames, prompt bytes, text bytes) an item."""
    g = torch.Generator().manual_seed(seed)
    b, nx, nr = len(specs), max(rb + gb for _, rb, gb in specs), max(r for r, _, _ in specs)
    x = torch.zeros(b, nx, dtype=torch.long)
    y_ref, mask = torch.zeros(b, nr, F5_CFG.mel_dim), torch.zeros(b, nr)
    for i, (r, rb, gb) in enumerate(specs):
        x[i, :rb + gb] = torch.randint(0, F5_CFG.text_num_embeds, (rb + gb,), generator=g)
        y_ref[i, :r] = torch.randn(r, F5_CFG.mel_dim, generator=g) * 2.0 - 5.0
        mask[i, :r] = 1
    noise = torch.randn(b, 400, F5_CFG.mel_dim, generator=g)
    return dict(x=x, x_lengths=torch.tensor([rb + gb for _, rb, gb in specs]), y_ref=y_ref, y_ref_mask=mask,
                x_ref_lengths=torch.tensor([rb for _, rb, _ in specs]), noise=noise)


@pytest.fixture(scope="module")
def f5():
    torch.manual_seed(4)
    return F5TTS(F5_CFG, device="cpu")


F5_SPECS = [(30, 6, 10), (52, 11, 5), (24, 5, 19), (70, 8, 8)]


@pytest.mark.parametrize("perm", [(0, 1, 2, 3), (3, 1, 0, 2)])
def test_f5_groups_equal_one_pass(f5, monkeypatch, perm):
    """F5-TTS's packed CFG rows cut per group: each item's generated frames
    against one pass at the batch's longest total, zero past each length.
    These totals are far shorter than a group's cost in frames, so the
    groups are taken at no cost a group: an item a group."""
    monkeypatch.setattr(sampler, "GROUP_FRAMES", 0)
    b = _f5_batch([F5_SPECS[i] for i in perm])
    run = lambda: sampler.synthesise(f5, b["x"], b["x_lengths"], b["noise"], b["y_ref"], n_timesteps=3, cfg=2.0,
                                     max_mel_len=4096, y_ref_mask=b["y_ref_mask"], x_ref_lengths=b["x_ref_lengths"],
                                     device="cpu")
    got = run()
    totals = got["total_lengths"].tolist()
    assert len(sampler.length_groups(totals, 1, max(totals))) == len(set(totals)) > 1
    with monkeypatch.context() as m:
        m.setattr(sampler, "length_groups", _one_pass)
        want = run()
    for key in ("y_lengths", "total_lengths", "ref_lengths", "y_clamped", "y_mask"):
        assert torch.equal(got[key], want[key]), key
    for r, n in enumerate(got["y_lengths"].tolist()):
        assert _rel(got["decoder_outputs"][r, :n], want["decoder_outputs"][r, :n]) < TOL
        assert bool((got["decoder_outputs"][r, n:] == 0).all())


def _frames(groups):
    """The frames a partition counts: its items times its frames, and GROUP_FRAMES a group."""
    return sum(len(rows) * f + sampler.GROUP_FRAMES for rows, f in groups)


@pytest.mark.parametrize("lengths,group_frames", [
    ([404, 60, 680, 212, 512], 768), ([404, 60, 680, 212, 512], 0),
    ([900, 30, 31, 700, 250, 260, 1000, 5], 768), ([900, 30, 31, 700, 250, 260, 1000, 5], 0),
    ([900, 30, 31, 700, 250, 260, 1000, 5], 4096), ([513] * 3 + [40] * 40, 768),
    ([1, 2, 3, 700, 701], 300)])
def test_partition_is_the_cheapest_contiguous_one(monkeypatch, lengths, group_frames):
    """Every item once, in contiguous runs of the order by length, each
    group at its longest length plus one frame rounded up, the longest group
    first, and no partition at the rounded lengths' boundaries counts fewer
    frames."""
    monkeypatch.setattr(sampler, "GROUP_FRAMES", group_frames)
    groups = sampler.length_groups(lengths, 256, 1024)
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    flat = [i for rows, _ in reversed(groups) for i in sorted(rows, key=lambda i: (lengths[i], i))]
    assert flat == order
    assert [f for _, f in groups] == sorted((f for _, f in groups), reverse=True)
    for rows, f in groups:
        assert rows == sorted(rows) and f == min(-(-(max(lengths[i] for i in rows) + 1) // 256) * 256, 1024)
    rounded = [min(-(-(lengths[i] + 1) // 256) * 256, 1024) for i in order]
    cuts = [j for j in range(1, len(order)) if rounded[j] != rounded[j - 1]]
    best = min(_frames([(order[a:e], rounded[e - 1]) for a, e in zip((0,) + c, c + (len(order),))])
               for k in range(len(cuts) + 1) for c in itertools.combinations(cuts, k))
    assert _frames(groups) == best


def test_the_cost_a_group_merges_groups(monkeypatch):
    """With no cost a group the batch splits at every rounded length; with
    a large one it keeps one group."""
    lengths = [900, 30, 700, 250, 600]
    monkeypatch.setattr(sampler, "GROUP_FRAMES", 0)
    split = sampler.length_groups(lengths, 256, 1024)
    monkeypatch.setattr(sampler, "GROUP_FRAMES", 4096)
    one = sampler.length_groups(lengths, 256, 1024)
    assert [f for _, f in split] == [1024, 768, 256] and one == [([0, 1, 2, 3, 4], 1024)]


@pytest.mark.parametrize("lengths,max_frames,want", [
    ([100, 30, 255, 1], 1024, [([0, 1, 2, 3], 256)]),   # every item rounds to one length: one group
    ([700, 30, 30, 30, 650], 600, [([0, 4], 600), ([1, 2, 3], 256)]),  # no group above the model's frames
    ([333], 1024, [([0], 512)]),                          # a batch of one: its own rounded frames
    ([5, 5, 5], 1024, [([0, 1, 2], 256)]),
    ([256], 1024, [([0], 512)]),                          # the frame past the item stays
    ([1024, 1024], 1024, [([0, 1], 1024)]),               # unless the model's frames end there
])
def test_partition_cases(lengths, max_frames, want):
    assert sampler.length_groups(lengths, 256, max_frames) == want


@pytest.mark.parametrize("length", [255, 256, 257, 512])
def test_a_group_holds_what_the_estimator_reads(stabletts, length):
    """The estimator's velocity on an item's frames, computed at its group's
    frames, equals the one at the cap's 1024: the group keeps the frame past
    the item, which the estimator's last long-skip conv reads."""
    ((_, frames),) = sampler.length_groups([length], 256, 1024)
    g = torch.Generator().manual_seed(length)
    mask = (torch.arange(1024) < length).float()[None]
    x = torch.randn(1, 1024, MEL_CFG.n_mels, generator=g)
    h_mu = stabletts.precompute_mu(torch.randn(1, 1024, MEL_CFG.n_mels, generator=g) * mask[..., None])
    c, t = torch.randn(1, MODEL_CFG.gin_channels, generator=g), torch.tensor([0.3])
    with torch.no_grad():
        full = stabletts.velocity(t, x, mask, h_mu, c, True)
        cut = stabletts.velocity(t, x[:, :frames], mask[:, :frames], h_mu[:, :frames].contiguous(), c, True)
    assert _rel(cut[0, :length], full[0, :length]) < TOL


def _traced(fn):
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    snap = metrics.snapshot()
    metrics.reset()
    return out, {k: v["calls"] for k, v in snap["spans"].items()}, snap["counters"]


@pytest.mark.parametrize("solver,steps", [("euler", 3), ("midpoint", 2)])
def test_counters_of_a_grouped_pass(stabletts, solver, steps):
    """`sampler.groups` counts the groups of a pass and
    `sampler.frames_computed` the items times each group's frames; one
    `sampler.ode` a pass, one `ode.step` a solver step of each group."""
    out, calls, counters = _traced(lambda: _stabletts_run(stabletts, (0, 1, 2, 3, 4), 3.0, solver, steps)[0])
    lengths = out["y_lengths"].tolist()
    groups = sampler.length_groups(lengths, 256, 1024)
    assert len(groups) > 1 and calls["sampler.ode"] == 1 and calls["ode.step"] == steps * len(groups)
    assert counters["sampler.groups"] == len(groups)
    assert counters["sampler.frames_computed"] == sum(len(rows) * f for rows, f in groups)
    assert counters["sampler.frames_valid"] == sum(lengths)


def test_an_adaptive_solver_runs_one_group(f5):
    """An adaptive solver's error norm spans the batch: one group at the
    model's frames (F5-TTS's longest total), whatever the lengths."""
    b = _f5_batch(F5_SPECS)
    out, calls, counters = _traced(lambda: sampler.synthesise(
        f5, b["x"], b["x_lengths"], b["noise"], b["y_ref"], n_timesteps=2, cfg=2.0, solver="dopri5",
        max_mel_len=4096, y_ref_mask=b["y_ref_mask"], x_ref_lengths=b["x_ref_lengths"], device="cpu"))
    totals = out["total_lengths"].tolist()
    assert len(set(totals)) == len(totals) and calls["sampler.ode"] == 1
    assert counters["sampler.groups"] == 1 and counters["sampler.frames_computed"] == len(totals) * max(totals)
