"""F5-TTS v1 Base in the port (stabletts_torch/models/f5tts.py, run through
models/sampler.py and Vocos at 24 kHz) against the plain reference
perfbench/reference/f5tts_ref.py, on seeded random weights at a small size
(dim 128, depth 2, 2 heads of 64, text_dim 64, 1 text block, 20 mels; a
Vocos of width 32 at n_fft 1024 / hop 256), on the CPU, where the blocks run
`dit_block`'s plain version.

Both sides compute in float32 here, so a tolerance covers only the order of
float32 sums (the port pre-scales q by log2(e) / sqrt(D) and takes exp2, and
rotates the permuted halves where the reference rotates interleaved pairs):
each is written beside its comparison, and each such case also checks that
the reference with its products' operands rounded to bfloat16 lies outside
it.
"""

import math
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stabletts_torch.config import F5Config, MelConfig, VocosConfig
from stabletts_torch.models import sampler
from stabletts_torch.models.f5tts import F5TTS, rope_permutation, sway_grid, total_frames
from stabletts_torch.models.vocos import Vocos
from stabletts_torch.ops.dit_block_cuda import apply_rope, rope_tables
from stabletts_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from perfbench.reference import f5tts_ref as R  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=64, text_num_embeds=40, conv_layers=1,
             mel_dim=20)
CFG = F5Config(**SMALL)
REF_CFG = {**SMALL, "n_mels": 20, "nfe_step": 4, "freq_embed_dim": 256, "conv_pos_kernel": 31, "conv_pos_groups": 16,
           "cfg_strength": 2.0, "sway_sampling_coef": -1.0, "n_fft": 1024,
           "vocoder": {"dim": 32, "intermediate_dim": 64, "num_layers": 2}}
MEL = MelConfig(sample_rate=24000, n_fft=1024, win_length=1024, hop_length=256, n_mels=20)
VOC = VocosConfig(input_channels=20, dim=32, intermediate_dim=64, num_layers=2)
BF16 = R.Precision("bf16")

# float32 on both sides: the order of the sums alone (1e-7 to 3e-7 here); the
# bf16-operand reference reads 5e-3 or more at these sizes
TOL = 1e-4


def _weights(seed: int = 0) -> dict:
    """Every published parameter uniform in +-1/sqrt(fan_in) (norms 1 +- 0.1,
    the adaLN gates and GRN not zero), and the buffers."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    shapes = R.parameter_shapes(REF_CFG)
    for name, shape in shapes.items():
        u = torch.rand(shape, generator=g) * 2 - 1
        if name.endswith("gamma"):
            out[name] = 0.1 + 0.01 * u
        elif len(shape) == 1 and "norm" in name:
            out[name] = 1.0 + 0.1 * u if name.endswith("weight") else 0.1 * u
        elif len(shape) == 1:
            w = shapes[name[: -len("bias")] + "weight"]
            out[name] = u / math.sqrt(math.prod(w[1:]))
        else:
            out[name] = u * (1.0 if "text_embed.weight" in name else 1.0 / math.sqrt(math.prod(shape[1:])))
    out.update(R.buffers(REF_CFG))
    return out


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def model(weights):
    m = F5TTS(CFG, device="cpu")
    m.load_state_dict({k: v for k, v in weights.items() if not k.startswith("vocoder.")}, strict=True)
    return m


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _item(seed: int, ref: int, ref_bytes: int, gen_bytes: int):
    """One item: ids (prompt text then text), its prompt's mel and noise over its whole length."""
    g = torch.Generator().manual_seed(seed)
    n = ref_bytes + gen_bytes
    ids = torch.randint(0, CFG.text_num_embeds, (n,), generator=g)
    mel = torch.randn(ref, CFG.mel_dim, generator=g) * 2.0 - 5.0
    total = total_frames(ref, ref_bytes, gen_bytes, n)
    noise = torch.randn(total, CFG.mel_dim, generator=g)
    return {"ids": ids, "mel": mel, "ref": ref, "ref_bytes": ref_bytes, "total": total, "noise": noise}


def _batch(items):
    b = len(items)
    x = torch.zeros(b, max(len(i["ids"]) for i in items), dtype=torch.long)
    y_ref = torch.zeros(b, max(i["ref"] for i in items), CFG.mel_dim)
    mask = torch.zeros(b, y_ref.shape[1])
    noise = torch.zeros(b, max(i["total"] for i in items), CFG.mel_dim)
    for r, i in enumerate(items):
        x[r, :len(i["ids"])] = i["ids"]
        y_ref[r, :i["ref"]] = i["mel"]
        mask[r, :i["ref"]] = 1
        noise[r, :i["total"]] = i["noise"]
    return dict(x=x, x_lengths=torch.tensor([len(i["ids"]) for i in items]), y_ref=y_ref, y_ref_mask=mask,
                x_ref_lengths=torch.tensor([i["ref_bytes"] for i in items]), noise=noise)


def _synth(model, items, steps=4, cfg=2.0):
    b = _batch(items)
    return sampler.synthesise(model, b["x"], b["x_lengths"], b["noise"], b["y_ref"], n_timesteps=steps, cfg=cfg,
                              max_mel_len=4096, y_ref_mask=b["y_ref_mask"], x_ref_lengths=b["x_ref_lengths"],
                              device="cpu")


def _ref_sample(weights, item, p=R.F32):
    out, dur = R.sample(weights, item["mel"][None], item["ids"][None], torch.tensor([item["total"]]),
                        item["noise"][None], REF_CFG, p)
    return out[0, item["ref"]:int(dur[0])]


def test_published_state_dict_loads_with_every_name(weights):
    """The port's module tree is the published one: the published names and
    shapes load with no key missing or unexpected."""
    m = F5TTS(CFG, device="cpu")
    tts = {k: v for k, v in weights.items() if not k.startswith("vocoder.")}
    res = m.load_state_dict(tts, strict=False)
    assert not res.missing_keys and not res.unexpected_keys
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {k: tuple(v.shape) for k, v in tts.items()}


def test_full_size_parameter_count():
    """F5-TTS v1 Base at its published widths is about 336M parameters."""
    n = sum(math.prod(s) for k, s in R.parameter_shapes({**REF_CFG, **{
        "dim": 1024, "depth": 22, "heads": 16, "text_dim": 512, "text_num_embeds": 2545, "conv_layers": 4,
        "n_mels": 100}}).items() if not k.startswith("vocoder."))
    assert 330e6 < n < 340e6, n


def test_permuted_half_split_rope_is_the_interleaved_rope():
    """q and k with each head's columns in `rope_permutation`'s order, rotated
    as halves over the whole head, are the reference's interleaved rotation
    permuted alike, so every score q . k is the reference's. f32 both: 1e-5
    covers sin/cos of the same angles and one product."""
    g = torch.Generator().manual_seed(1)
    b, t, h, d = 2, 37, 3, 64
    q, k = torch.randn(b, t, h, d, generator=g), torch.randn(b, t, h, d, generator=g)
    perm = rope_permutation(h, d).view(h, d)[0]
    cos, sin = rope_tables(t, d, "cpu", rot=d)
    qp, kp = apply_rope(q[..., perm], cos, sin), apply_rope(k[..., perm], cos, sin)
    freqs = R.rotary(t, d, "cpu")
    qr, kr = R.apply_rotary(q, freqs), R.apply_rotary(k, freqs)
    assert torch.allclose(qp, qr[..., perm], atol=1e-5, rtol=0)
    s_port = torch.einsum("bqhd,bkhd->bhqk", qp, kp)
    s_ref = torch.einsum("bqhd,bkhd->bhqk", qr, kr)
    assert _rel(s_port, s_ref) < 1e-5
    unpermuted = apply_rope(q, cos, sin)  # the half-split form on the published columns is another rotation
    assert _rel(unpermuted, qr) > 0.1


def test_sway_grid():
    """The port's grid is cfm.py's; at coefficient -1 it is 1 - cos(pi t / 2)."""
    got = sway_grid(32, -1.0, "cpu")
    t = torch.linspace(0, 1, 33)
    assert torch.equal(got, t + -1.0 * (torch.cos(torch.pi / 2 * t) - 1 + t))
    assert torch.allclose(got, 1 - torch.cos(torch.pi / 2 * t), atol=1e-6)
    assert got[0] == 0 and abs(float(got[-1]) - 1) < 1e-6 and bool((got.diff() > 0).all())


@pytest.mark.parametrize("ref_frames,ref_text,gen_text,speed", [
    (563, "Some call me nature, others call me mother nature.", "I don't really care what you call me.", 1.0),
    (281, "短い参照。", "生成するテキストです。", 1.0),
    (1125, "x" * 168, "y" * 140, 1.0),
    (400, "a b c", "d", 0.8),
])
def test_byte_ratio_durations(model, ref_frames, ref_text, gen_text, speed):
    """The rule on UTF-8 bytes, one id a byte, through `prepare`: the totals
    and the generated frames that `synthesise` returns."""
    rb, gb = len(ref_text.encode()), len(gen_text.encode())
    want = R.total_frames(ref_frames, ref_text, gen_text, speed)
    assert total_frames(ref_frames, rb, gb, rb + gb, speed) == max(want, max(rb + gb, ref_frames) + 1)
    x = torch.randint(0, CFG.text_num_embeds, (1, rb + gb))
    y_ref = torch.zeros(1, ref_frames, CFG.mel_dim)
    prep = model.prepare_synthesis(x, torch.tensor([rb + gb]), y_ref, 0, 1.0 / speed,
                                   x_ref_lengths=torch.tensor([rb]))
    assert int(prep["y_lengths"][0]) == want and int(prep["gen_lengths"][0]) == want - ref_frames
    assert prep["y_mask"].shape == (1, want) and not bool(prep["y_clamped"][0])


def _velocities(model, weights, item, branch, p=R.F32):
    """(port, reference) velocity of one item at t = 0.37: the conditioned
    branch, the null branch (no prompt, no text), or the packed CFG pass."""
    b = _batch([item])
    prep = model.prepare_synthesis(b["x"], b["x_lengths"], b["y_ref"], 0, 1.0, b["y_ref_mask"], None,
                                   b["x_ref_lengths"])
    xt = b["noise"]
    t = torch.tensor(0.37)
    step_cond = prep["cond"]
    text_cond = R.text_embed(weights, item["ids"][None], item["total"], False, REF_CFG, p)
    text_null = R.text_embed(weights, item["ids"][None], item["total"], True, REF_CFG, p)
    with torch.no_grad():
        if branch == "cfg":
            got = model.flow_velocity(model.flow_condition(prep, 2.0), t, xt, 2.0)
            pred, null = R.dit(weights, xt, step_cond, text_cond, text_null, t[None], None, True, REF_CFG, p).chunk(2)
            return got, pred + (pred - null) * 2.0
        if branch == "cond":
            got = model.flow_velocity(model.flow_condition(prep, 0.0), t, xt, 0.0)
            return got, R.dit(weights, xt, step_cond, text_cond, None, t[None], None, False, REF_CFG, p)
        m = prep["y_mask"][..., None]
        h = model.transformer.input_embed(xt, torch.zeros_like(step_cond), prep["text"][1:], m) * m
        got = model.transformer(h, t[None], prep["y_mask"])
        return got, R.dit(weights, xt, torch.zeros_like(step_cond), text_null, None, t[None], None, False, REF_CFG, p)


@pytest.mark.parametrize("branch", ["cond", "null", "cfg"])
def test_velocity_matches_reference(model, weights, branch):
    item = _item(3, 41, 9, 13)
    got, want = _velocities(model, weights, item, branch)
    assert got.shape == (1, item["total"], CFG.mel_dim)
    assert _rel(got, want) < TOL, _rel(got, want)
    _, coarse = _velocities(model, weights, item, branch, BF16)
    assert _rel(coarse, want) > TOL  # the tolerance is tighter than bf16 products


def test_synthesise_with_a_prompt_matches_reference(model, weights):
    """`synthesise` (prepare, then sample: 4 sway-sampled Euler steps, CFG 2)
    returns the generated frames alone, as the reference's sample cut after the prompt."""
    item = _item(5, 37, 8, 17)
    out = _synth(model, [item])
    gen = item["total"] - item["ref"]
    assert out["decoder_outputs"].shape == (1, gen, CFG.mel_dim) and int(out["y_lengths"][0]) == gen
    want = _ref_sample(weights, item)
    assert _rel(out["decoder_outputs"][0], want) < TOL
    assert _rel(_ref_sample(weights, item, BF16), want) > TOL


def test_ragged_batch_equals_each_item_alone(model):
    """Three items of other prompt, text and total lengths in one padded
    batch give each item's result alone: padded keys are masked, the grouped
    convs and the text blocks see each item's own frames. f32 both: only the
    shapes of the sums differ (1e-5)."""
    items = [_item(11, 30, 6, 10), _item(12, 52, 11, 5), _item(13, 24, 5, 19)]
    out = _synth(model, items)
    for r, item in enumerate(items):
        alone = _synth(model, [item])
        n = int(alone["y_lengths"][0])
        assert int(out["y_lengths"][r]) == n
        assert _rel(out["decoder_outputs"][r, :n], alone["decoder_outputs"][0]) < 1e-5
        assert bool((out["decoder_outputs"][r, n:] == 0).all())


def test_vocoder_at_24k_matches_reference(weights):
    """Vocos at n_fft 1024 / hop 256 with `lengths` (the serving mode) equals
    the reference Vocos on each trimmed mel. f32 both; the port's inverse DFT
    is a product over the packed spectrum (1e-4)."""
    voc = Vocos(VOC, MEL, device="cpu")
    voc.load_state_dict({k[len("vocoder."):]: v for k, v in weights.items() if k.startswith("vocoder.")}, strict=True)
    P = {k[len("vocoder."):]: v for k, v in weights.items() if k.startswith("vocoder.")}
    g = torch.Generator().manual_seed(7)
    mel = torch.randn(2, 23, 20, generator=g) - 4.0
    lengths = torch.tensor([23, 15])
    wav = voc(mel, lengths)
    assert wav.shape == (2, 23 * 256)
    for r, n in enumerate(lengths.tolist()):
        want = R.vocos(P, mel[r, :n], 1024, 256, 2)
        assert _rel(wav[r, :n * 256], want) < 1e-4
    assert _rel(R.vocos(P, mel[0], 1024, 256, 2, BF16), R.vocos(P, mel[0], 1024, 256, 2)) > 1e-4


def test_spans_and_counters_of_a_batch(model):
    """A traced batch of two at CFG 2 and 3 steps opens one `sampler.prepare`
    with one `f5.text_embed` inside it, one `sampler.ode` with 3 `ode.step`
    a length group and one `f5.input_embed` a step, and counts each item's
    total frames, the groups, the items times the frames each group computes
    and the prompts' frames once."""
    items = [_item(21, 30, 6, 10), _item(22, 44, 9, 12)]
    untraced = _synth(model, items, steps=3)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _synth(model, items, steps=3)
    assert torch.equal(traced["decoder_outputs"], untraced["decoder_outputs"])  # tracing changes no result
    snap = metrics.snapshot()
    totals = [i["total"] for i in items]
    groups = sampler.length_groups(totals, 1, max(totals))
    assert groups == [([0, 1], max(totals))]  # two short items: one group at the longest total
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    assert calls == {"sampler.prepare": 1, "f5.text_embed": 1, "sampler.ode": 1, "ode.step": 3 * len(groups),
                     "f5.input_embed": 3 * len(groups)}
    assert snap["counters"] == {"sampler.frames_valid": sum(totals), "sampler.groups": len(groups),
                                "sampler.frames_computed": sum(len(rows) * frames for rows, frames in groups),
                                "f5.prompt_frames": 30 + 44}
    parents = {r[0]: metrics.records()[r[3]][0] for r in metrics.records() if r[3] >= 0}
    assert parents["f5.text_embed"] == "sampler.prepare" and parents["f5.input_embed"] == "ode.step"
    metrics.reset()


def test_adaptive_solver_error_norm_covers_the_computed_frames(model):
    """An adaptive solver's error norm is taken over the frames the estimator
    computes (the longest total), not over the cap on the totals: a cap that
    clips nothing (4096) takes the same steps, to the bit, as the cap at the
    item's own total."""
    item = _item(31, 30, 6, 10)
    b = _batch([item])
    outs = [sampler.synthesise(model, b["x"], b["x_lengths"], b["noise"], b["y_ref"], n_timesteps=4, cfg=2.0,
                               solver="dopri5", max_mel_len=cap, y_ref_mask=b["y_ref_mask"],
                               x_ref_lengths=b["x_ref_lengths"], device="cpu") for cap in (4096, item["total"])]
    assert int(outs[0]["y_lengths"][0]) == int(outs[1]["y_lengths"][0]) == item["total"] - item["ref"]
    assert torch.equal(outs[0]["decoder_outputs"], outs[1]["decoder_outputs"])
