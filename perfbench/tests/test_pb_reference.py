"""The plain reference against the port's CPU path at a tiny size (the same
seeded weights in both), its text ids against the port's front end, and its
log-mel against the port's. The reference itself imports nothing of the
port."""

import ast
import os

import pytest
import torch

import pb_helpers
from perfbench.lib import core
from perfbench.lib.weights import calibrate_durations, make_weights, split
from perfbench.reference import stabletts_ref as R
from perfbench.reference import text_en
from perfbench.traffic import sentences

CFG = dict(core.load_json(f"{core.PKG_DIR}/configs/stabletts-v1.1-vocos44k-serve.json"), **pb_helpers.TINY_MODEL)


def _models(seed):
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.models.vocos import Vocos
    from perfbench.lib import program

    w = make_weights(R.parameter_shapes(CFG, CFG["n_vocab"]), CFG, seed, "cpu")
    calibrate_durations(w, CFG, seed, "cpu")
    tts, voc = split(w)
    model, vocos = program.build(CFG, tts, voc, "cpu")
    return model, vocos, tts, voc


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 1])
def test_reference_matches_port_cpu(seed):
    from stabletts_torch.models.sampler import synthesise

    model, vocos, P, V = _models(seed)
    g = torch.Generator().manual_seed(seed)
    b, n, cap = 2, 12, 256
    ids = torch.zeros(b, 2 * n + 1, dtype=torch.long)
    ids[:, 1::2] = torch.randint(1, 401, (b, n), generator=g)
    x_len = torch.tensor([2 * n + 1, 2 * n - 5])
    ids[1, 2 * n - 5:] = 0
    y_ref = torch.randn(b, 40, 128, generator=g) * 2 - 5
    noise = torch.randn(b, cap, 128, generator=g)
    out = synthesise(model, ids, x_len, noise, y_ref, n_timesteps=CFG["n_timesteps"], cfg=3.0, max_mel_len=cap,
                     length_scale=2.0, device="cpu")
    wav = vocos(out["decoder_outputs"], out["y_lengths"])
    with torch.no_grad():
        for i in range(b):
            m = int(x_len[i])
            c, mu_x, _, w = R.encode(P, ids[i:i + 1, :m], x_len[i:i + 1], y_ref[i:i + 1], None, CFG)
            frames = R.frames_from_w(w, 2.0)
            assert torch.equal(frames[0], out["attn"][i, :m].sum(-1))
            mel, y = R.decode(P, c, mu_x, frames, noise[i:i + 1], cap, CFG["n_timesteps"], 3.0, CFG)
            y = int(y[0])
            assert y == int(out["y_lengths"][i])
            mel_p = out["decoder_outputs"][i, :y]
            assert float((mel_p - mel[0, :y]).norm() / mel[0, :y].norm()) < 1e-5
            wav_r = R.vocos(V, mel_p, CFG["n_fft"], CFG["hop_length"], CFG["vocoder"]["num_layers"])
            wav_p = wav[i, :y * CFG["hop_length"]]
            assert float((wav_p - wav_r).norm() / wav_r.norm()) < 1e-3


def test_log_mel_matches_port():
    from stabletts_torch.config import MelConfig
    from stabletts_torch.ops.stft import log_mel_spectrogram

    clip = sentences.clips({"clips": {"n": 1, "min_s": 0.5, "max_s": 0.6}}, 4, 44100)[0]
    ours = R.log_mel(torch.from_numpy(clip), 44100, 2048, 512, 128)
    port = log_mel_spectrogram(torch.from_numpy(clip)[None], MelConfig())[0]
    assert ours.shape == port.shape
    assert float((ours - port).abs().max()) < 1e-3


def test_text_ids_match_port_front_end():
    from stabletts_torch.text import cleaned_text_to_sequence, intersperse
    from stabletts_torch.text.english import english_to_ipa2

    p = {"pool": 300, "words": {"median": 14, "sigma": 0.75, "min": 1, "max": 40}}
    for s in sentences.sentences(p, 21):
        assert text_en.sentence_ids(s) == intersperse(cleaned_text_to_sequence(english_to_ipa2(s)), 0)


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(core.PKG_DIR, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("stabletts_torch", "stabletts_tpu", "jax", "jaxlib", "flax"), (name, m)


def test_fp8_control_rounds():
    x = torch.linspace(-3, 3, 101)
    q = R.Precision("fp8").q(x)
    assert not torch.equal(q, x) and bool(((q - x).abs() <= 0.0625 * x.abs() + 1e-6).all())
    assert torch.equal(R.F32.q(x), x)
