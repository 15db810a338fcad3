"""The port's Vocos GAN training against the JAX package on the CPU: the MPD
stack kernel's plain version against the Pallas kernel (interpret mode) and
both packages' DiscriminatorP; the discriminators, the weight-norm fold, the
losses and `stft_real_imag` with converted weights; one whole GAN step (both
updates, every metric, the updated parameters) against
`make_vocos_train_step`; `train_vocos` end to end with a resume; the
converters through a round trip; `audio_io` and `VocosDataset` against their
originals on WAV files the test writes.

The generator is tiny (dim 32, 2 layers, 20 mels, n_fft 256); the
discriminators have no size parameter and are the real ones. The JAX GAN step
compiles slowly on the CPU, so it is built and run once per module.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from stabletts_torch.config import MelConfig, VocosConfig, VocosTrainConfig
from stabletts_torch.models import discriminators as td
from stabletts_torch.models import gan_losses as tl
from stabletts_torch.ops.mpd_cuda import mpd_stack
from stabletts_torch.train.train_vocos import init_vocos_training, train_vocos, vocos_train_step
from stabletts_torch.utils import convert
from stabletts_tpu.models import discriminators as jd
from stabletts_tpu.models import gan_losses as jl
from torch_port_utils import n, t

torch.set_num_threads(2)

MEL = MelConfig(n_fft=256, win_length=256, hop_length=64, n_mels=20)
VOCOS = VocosConfig(input_channels=20, dim=32, intermediate_dim=64, num_layers=2)
SEGMENT = 2048
BF16_BAR = 1.5e-2  # bf16 GAN step against the JAX bf16 step: about 3x the worst seen (grad_norm_g, 4.6e-3)


def _perturb(params, seed):
    """numpy copy of a flax tree with every 1-D leaf (biases, weight-norm
    scales, LayerNorm scales, gamma) moved off its initial value."""
    rng = np.random.default_rng(seed)

    def visit(leaf):
        leaf = np.asarray(leaf, np.float32)
        if leaf.ndim == 1:
            return (leaf * (1.0 + 0.2 * rng.standard_normal(leaf.shape)) + 0.02 * rng.standard_normal(leaf.shape)) \
                .astype(np.float32)
        return leaf

    return jax.tree_util.tree_map(visit, params)


def _audio(b, length, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((b, length)) * scale).astype(np.float32)


def _nhwc(fm):
    """The port's [B, C, L, W] feature map in the JAX package's [B, L, W, C]."""
    return n(fm).transpose(0, 2, 3, 1)


# ---- discriminators -------------------------------------------------------------------

@pytest.mark.parametrize("t_len,period", [(20480, 2), (8190, 3), (4097, 5), (3001, 7)])
def test_mpd_stack_matches_pallas_interpret_and_both_discriminators(t_len, period):
    """`mpd_stack` (its plain version on the CPU) against mpd_stack_fused in
    interpret mode, the flax DiscriminatorP and the port's, 2e-4 max-abs
    (tests/test_mpd_pallas.py:29). The first two lengths divide by their
    period; the odd lengths of periods 5 and 7, and the (8191, 3) case below,
    take the reflect pad."""
    _check_mpd_stack(t_len, period)


def test_mpd_stack_reflect_pad():
    _check_mpd_stack(8191, 3)


def _check_mpd_stack(t_len, period):
    from stabletts_tpu.ops.mpd_pallas import mpd_stack_fused

    x = _audio(2, t_len, seed=period)
    d = jd.DiscriminatorP(period=period, use_weight_norm=False)
    params = d.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref_logits, ref_fmaps = d.apply({"params": params}, jnp.asarray(x))
    pal_logits, pal_fmaps = mpd_stack_fused(jnp.asarray(x), params, period=period, interpret=True)

    folded = [(t(np.transpose(np.asarray(params[k]["kernel"]), (3, 2, 0, 1))), t(np.asarray(params[k]["bias"])))
              for k in [f"convs_{i}" for i in range(5)] + ["conv_post"]]
    before = mpd_stack.launches
    logits, fmaps = mpd_stack(t(x), folded, period)
    assert mpd_stack.launches == before  # CPU: the plain version
    port = td.DiscriminatorP(period)
    port_logits, port_fmaps = port(t(x), folded)

    assert len(fmaps) == len(port_fmaps) == 5
    for got, mine, ref, pal in zip([logits, *fmaps], [port_logits, *port_fmaps], [ref_logits, *ref_fmaps],
                                   [pal_logits, *pal_fmaps]):
        got_j = n(got) if got.dim() == 2 else _nhwc(got)
        assert got_j.shape == np.asarray(ref).shape == np.asarray(pal).shape
        assert np.abs(got_j - np.asarray(pal)).max() < 2e-4
        assert np.abs(got_j - np.asarray(ref)).max() < 2e-4
        assert got.shape == mine.shape and (got - mine).abs().max() < 2e-4


def test_discriminator_p_with_weight_norm_matches_flax():
    x = _audio(2, 4001, seed=1)
    d = jd.DiscriminatorP(period=3)
    params = _perturb(d.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 3)
    want_logits, want_fmaps = d.apply({"params": params}, jnp.asarray(x))
    port = td.DiscriminatorP(3)
    sd = convert.state_dict_from_jax_mpd({"discriminators_0": params})
    port.load_state_dict({k[len("discriminators.0."):]: v for k, v in sd.items()})
    logits, fmaps = port(t(x))
    np.testing.assert_allclose(n(logits), np.asarray(want_logits), rtol=2e-4, atol=2e-4)
    for got, want in zip(fmaps, want_fmaps):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window_length", [512, 2048])
def test_discriminator_r_matches_flax(window_length):
    x = _audio(2, 8192, seed=window_length)
    d = jd.DiscriminatorR(window_length=window_length)
    params = _perturb(d.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 4)
    want_out, want_fmaps = d.apply({"params": params}, jnp.asarray(x))
    port = td.DiscriminatorR(window_length)
    sd = convert.state_dict_from_jax_mrd({"discriminators_0": params})
    port.load_state_dict({k[len("discriminators.0."):]: v for k, v in sd.items()})
    out, fmaps = port(t(x))
    assert len(fmaps) == len(want_fmaps) == 21
    for got, want in zip([out, *fmaps], [want_out, *want_fmaps]):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_weight_norm_fold_matches_flax_fold():
    """`fold` gives flax's v * rsqrt(sum v^2 + 1e-12) * scale, and applying
    the folded kernels equals applying the (g, v) pairs."""
    x = _audio(2, 3000, seed=5)
    d = jd.DiscriminatorP(period=5)
    params = _perturb(d.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 6)
    folded_j = jd.fold_weightnorm(params)
    port = td.DiscriminatorP(5)
    sd = convert.state_dict_from_jax_mpd({"discriminators_0": params})
    port.load_state_dict({k[len("discriminators.0."):]: v for k, v in sd.items()})
    folded = port.fold()
    names = [f"convs_{i}" for i in range(5)] + ["conv_post"]
    for name, (w, b) in zip(names, folded):
        np.testing.assert_allclose(n(w).transpose(2, 3, 1, 0), np.asarray(folded_j[name]["kernel"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(n(b), np.asarray(folded_j[name]["bias"]))
    a, b = port(t(x)), port(t(x), folded)
    assert torch.equal(a[0], b[0])


def test_stft_real_imag_matches_jax():
    x = _audio(2, 2048, seed=7, scale=1.0)
    got = td.stft_real_imag(t(x), 512, 128, 512)
    want = jd.stft_real_imag(jnp.asarray(x), 512, 128, 512)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(8)
    real = [rng.standard_normal(s).astype(np.float32) for s in ((2, 30), (2, 1, 7, 5))]
    fake = [rng.standard_normal(s).astype(np.float32) for s in ((2, 30), (2, 1, 7, 5))]
    fr = [[rng.standard_normal((2, 4, 6, 3)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    fg = [[rng.standard_normal((2, 4, 6, 3)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    j = lambda xs: [jnp.asarray(a) for a in xs]
    tt = lambda xs: [t(a) for a in xs]
    close = lambda got, want: np.testing.assert_allclose(float(got), float(want), rtol=2e-4, atol=2e-4)

    loss, r_l, g_l = tl.discriminator_loss(tt(real), tt(fake))
    jloss, jr_l, jg_l = jl.discriminator_loss(j(real), j(fake))
    close(loss, jloss)
    for a, b in zip(r_l + g_l, jr_l + jg_l):
        close(a, b)
    gl, gls = tl.generator_loss(tt(fake))
    jgl, jgls = jl.generator_loss(j(fake))
    close(gl, jgl)
    for a, b in zip(gls, jgls):
        close(a, b)
    close(tl.feature_loss([tt(d) for d in fr], [tt(d) for d in fg]), jl.feature_loss([j(d) for d in fr], [j(d) for d in fg]))

    from stabletts_tpu.config import MelConfig as JMelConfig

    x, y = _audio(2, 4096, seed=9), _audio(2, 4096, seed=10)
    cfgs, jcfgs = tl.multi_scale_mel_configs(MEL), jl.multi_scale_mel_configs(JMelConfig(**dataclasses.asdict(MEL)))
    assert [dataclasses.asdict(c) for c in cfgs] == [dataclasses.asdict(c) for c in jcfgs] and len(cfgs) == 7
    close(tl.multi_scale_mel_loss(t(x), t(y), cfgs), jl.multi_scale_mel_loss(jnp.asarray(x), jnp.asarray(y), jcfgs))
    close(tl.single_scale_mel_loss(t(x), t(y), cfgs[3]),
          jl.single_scale_mel_loss(jnp.asarray(x), jnp.asarray(y), jcfgs[3]))
    assert float(tl.multi_scale_mel_loss(t(x), t(x), cfgs)) == 0.0


# ---- one whole GAN step ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gan_steps():
    """Two steps of the JAX package's GAN step on one batch from a perturbed
    initial state (the first has lr 0 under the warm-up, as the reference's
    scheduler). Returns the initial trees, both steps' metrics and the trees
    after the second step, all numpy."""
    from stabletts_tpu.config import MelConfig as JMelConfig
    from stabletts_tpu.config import VocosConfig as JVocosConfig
    from stabletts_tpu.config import VocosTrainConfig as JVocosTrainConfig
    from stabletts_tpu.train.train_vocos import init_vocos_training as jinit

    jcfg = JVocosTrainConfig(segment_size=SEGMENT, batch_size=2, warmup_steps=1, learning_rate=1e-3)
    _, _, _, state, step_fn = jinit(JVocosConfig(**dataclasses.asdict(VOCOS)), JMelConfig(**dataclasses.asdict(MEL)),
                                    jcfg, 10)
    init = {"g": _perturb(state.params_g, 11), "mpd": _perturb(state.params_mpd, 12),
            "mrd": _perturb(state.params_mrd, 13)}
    state = state.replace(params_g=init["g"], params_mpd=init["mpd"], params_mrd=init["mrd"])
    audio = _audio(2, SEGMENT, seed=14, scale=0.1)
    metrics = []
    for _ in range(2):
        state, m = step_fn(state, jnp.asarray(audio))
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree_util.tree_map(np.asarray, {"g": state.params_g, "mpd": state.params_mpd, "mrd": state.params_mrd})
    return init, audio, metrics, final


def _port_state(init, lr=1e-3):
    cfg = VocosTrainConfig(segment_size=SEGMENT, batch_size=2, warmup_steps=1, learning_rate=lr)
    state = init_vocos_training(VOCOS, MEL, cfg, 10, device="cpu")
    state.gen.load_state_dict(convert.state_dict_from_jax_vocos(init["g"], VOCOS.num_layers))
    state.mpd.load_state_dict(convert.state_dict_from_jax_mpd(init["mpd"]))
    state.mrd.load_state_dict(convert.state_dict_from_jax_mrd(init["mrd"]))
    return state, cfg


def test_gan_step_matches_jax(jax_gan_steps):
    """Every metric of both steps within 1e-3 (rel), and the parameters after
    them: Adam's first update moves every element by about lr whatever the
    gradient's size, so an element whose gradient is f32 noise may differ by
    2 * lr; every element is within that, and all but 1e-3 of them within
    1e-2 of their tensor's largest move."""
    init, audio, jmetrics, final = jax_gan_steps
    state, cfg = _port_state(init)
    metrics = [{k: float(v) for k, v in vocos_train_step(state, t(audio), MEL, cfg.mel_loss_coeff,
                                                         cfg.grad_clip).items()} for _ in range(2)]
    assert state.step == 2
    for got, want in zip(metrics, jmetrics):
        assert set(got) == set(want) and len(got) == 11
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]) + 1e-6, (k, got[k], want[k])

    lr = cfg.learning_rate
    for module, before, after in (
            (state.gen, convert.state_dict_from_jax_vocos(init["g"], VOCOS.num_layers),
             convert.state_dict_from_jax_vocos(final["g"], VOCOS.num_layers)),
            (state.mpd, convert.state_dict_from_jax_mpd(init["mpd"]), convert.state_dict_from_jax_mpd(final["mpd"])),
            (state.mrd, convert.state_dict_from_jax_mrd(init["mrd"]), convert.state_dict_from_jax_mrd(final["mrd"]))):
        off = total = 0
        sd = module.state_dict()
        assert set(sd) == set(after)
        for name, p in sd.items():
            moved = (after[name] - before[name]).abs().max().item()
            assert moved > 0, name  # the second step has lr > 0: everything moves
            err = (p - after[name]).abs()
            assert err.max().item() <= 2 * lr * 1.01, name
            off += int((err > 1e-2 * moved).sum())
            total += err.numel()
        assert off <= 1e-3 * total, (off, total)


@pytest.fixture(scope="module")
def jax_gan_step_bf16(jax_gan_steps):
    """The first step's metrics of the JAX package's GAN step with
    compute_dtype bfloat16, from the same initial state and batch."""
    from stabletts_tpu.config import MelConfig as JMelConfig
    from stabletts_tpu.config import VocosConfig as JVocosConfig
    from stabletts_tpu.config import VocosTrainConfig as JVocosTrainConfig
    from stabletts_tpu.train.train_vocos import init_vocos_training as jinit

    init, audio, _, _ = jax_gan_steps
    jcfg = JVocosTrainConfig(segment_size=SEGMENT, batch_size=2, warmup_steps=1, learning_rate=1e-3,
                             compute_dtype="bfloat16")
    _, _, _, state, step_fn = jinit(JVocosConfig(**dataclasses.asdict(VOCOS)), JMelConfig(**dataclasses.asdict(MEL)),
                                    jcfg, 10)
    state = state.replace(params_g=init["g"], params_mpd=init["mpd"], params_mrd=init["mrd"])
    _, m = step_fn(state, jnp.asarray(audio))
    return {k: float(v) for k, v in m.items()}


def test_gan_step_bf16_runs_close_to_f32(jax_gan_steps, jax_gan_step_bf16):
    """`compute_dtype=torch.bfloat16`: f32 master parameters and metrics, all
    finite, the losses within 0.1 (rel) of the f32 step's, and every metric
    within BF16_BAR (rel) of the JAX package's bf16 step: both round the same
    tensors to bf16 and run the same branches in f32 (the fake audio stays
    f32, so the MPD's fake branch and the whole MRD run in f32), and differ
    in the order of their bf16 sums."""
    init, audio, jmetrics, _ = jax_gan_steps
    state, cfg = _port_state(init)
    m = vocos_train_step(state, t(audio), MEL, cfg.mel_loss_coeff, cfg.grad_clip, torch.bfloat16)
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in m.values())
    assert all(p.dtype == torch.float32 for mod in (state.gen, state.mpd, state.mrd) for p in mod.parameters())
    for k in ("gen_loss_total", "disc_loss_mpd", "disc_loss_mrd", "mel_loss"):
        assert abs(float(m[k]) - jmetrics[0][k]) <= 0.1 * abs(jmetrics[0][k]), (k, float(m[k]), jmetrics[0][k])
    assert set(m) == set(jax_gan_step_bf16)
    errs = {k: abs(float(m[k]) - want) / abs(want) for k, want in jax_gan_step_bf16.items()}
    print("bf16 GAN step, rel err against the JAX bf16 step:", errs)
    assert max(errs.values()) <= BF16_BAR, errs


def test_generator_trains_through_the_istft_gradient(monkeypatch):
    """STABLETTS_ISTFT_IMPL=fused takes `istft_head_diff` (the kernel forward,
    here its plain version, with the transpose of the plain ISTFT as its
    backward): the same waveform and parameter gradients as the plain path."""
    from stabletts_torch.models.vocos import Vocos

    torch.manual_seed(0)
    gen = Vocos(VOCOS, MEL, device="cpu").train()
    mel = t(np.random.default_rng(15).standard_normal((2, 24, 20)).astype(np.float32))
    cot = t(_audio(2, 24 * 64, seed=16))
    runs = {}
    for impl in ("xla", "fused"):
        monkeypatch.setenv("STABLETTS_ISTFT_IMPL", impl)
        gen.zero_grad()
        wav = gen(mel)
        (wav * cot).sum().backward()
        runs[impl] = (wav.detach(), {k: p.grad.clone() for k, p in gen.named_parameters()})
    np.testing.assert_allclose(n(runs["fused"][0]), n(runs["xla"][0]), rtol=1e-5, atol=1e-5)
    for k, g in runs["xla"][1].items():
        np.testing.assert_allclose(n(runs["fused"][1][k]), n(g), rtol=1e-4, atol=1e-5 * float(g.abs().max()) + 1e-8)
    gen.eval()
    assert not gen(mel).requires_grad  # serving stays under no_grad


# ---- converters, data, train_vocos end to end -----------------------------------------------------

def test_discriminator_converters_round_trip_bit_for_bit():
    for cls, to_port in ((td.MultiPeriodDiscriminator, convert.state_dict_from_jax_mpd),
                         (td.MultiResolutionDiscriminator, convert.state_dict_from_jax_mrd)):
        torch.manual_seed(1)
        sd = cls().state_dict()
        tree = convert.jax_params_from_discriminator({k: v.numpy() for k, v in sd.items()})
        back = to_port(tree)
        assert set(back) == set(sd)
        assert all(torch.equal(back[k], sd[k]) for k in sd)
    old = {"discriminators.0.convs.0.weight_g": torch.ones(32, 1, 1, 1), "discriminators.0.convs.0.bias": torch.zeros(32)}
    assert set(convert.load_discriminator_state_dict(old)) == {
        "discriminators.0.convs.0.parametrizations.weight.original0", "discriminators.0.convs.0.bias"}


def test_flax_tree_from_port_state_dict_is_the_flax_structure():
    x = jnp.zeros((1, 2048))
    for jcls, tcls in ((jd.MultiPeriodDiscriminator, td.MultiPeriodDiscriminator),
                       (jd.MultiResolutionDiscriminator, td.MultiResolutionDiscriminator)):
        params = jcls().init(jax.random.PRNGKey(0), x, x)["params"]
        tree = convert.jax_params_from_discriminator({k: v.numpy() for k, v in tcls().state_dict().items()})
        shapes = lambda tr: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tr)
        assert shapes(tree) == shapes(jax.tree_util.tree_map(np.asarray, params))


def _write_wavs(root, count, sr, seconds=0.2, seed=0, dtype=np.int16):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(count):
        wav = (rng.standard_normal(int(sr * seconds * (1 + 0.3 * i))) * 0.2).clip(-1, 1)
        wavfile.write(os.path.join(root, f"clip_{i}.wav"), sr, (wav * 32767).astype(dtype))


def test_audio_io_matches_jax_package(tmp_path):
    from stabletts_torch.utils import audio_io as ta
    from stabletts_tpu.utils import audio_io as ja

    _write_wavs(tmp_path, 2, 22050)
    path = str(tmp_path / "clip_1.wav")
    (wav, sr), (jwav, jsr) = ta.load_audio(path), ja.load_audio(path)
    assert sr == jsr == 22050 and np.array_equal(wav, jwav) and wav.dtype == np.float32
    assert np.array_equal(ta.resample(wav, sr, 44100), ja.resample(jwav, jsr, 44100))
    assert np.array_equal(ta.load_and_resample_audio(path, 22050), wav)
    ta.save_wav(str(tmp_path / "out.wav"), wav, sr)
    ja.save_wav(str(tmp_path / "jout.wav"), jwav, jsr)
    assert np.array_equal(wavfile.read(tmp_path / "out.wav")[1], wavfile.read(tmp_path / "jout.wav")[1])
    stereo = np.stack([wav, -wav], axis=1)
    wavfile.write(tmp_path / "stereo.wav", sr, (stereo * 32767).astype(np.int16))
    assert np.array_equal(ta.load_audio(str(tmp_path / "stereo.wav"))[0], ja.load_audio(str(tmp_path / "stereo.wav"))[0])
    # a truncated FLAC: both packages' Python decoders run out of bits, and the loader gives up as in the JAX package
    (tmp_path / "x.flac").write_bytes(b"fLaC" + b"\0" * 16)
    for pkg in (ta, ja):
        with pytest.raises(EOFError):
            pkg.load_audio(str(tmp_path / "x.flac"))
    assert ta.load_and_resample_audio(str(tmp_path / "x.flac"), 44100) is None
    assert ja.load_and_resample_audio(str(tmp_path / "x.flac"), 44100) is None


def test_vocos_dataset_matches_jax_package(tmp_path):
    from stabletts_torch.data import vocos_dataset as tv
    from stabletts_tpu.data import vocos_dataset as jv

    _write_wavs(tmp_path / "wavs", 4, 44100)
    (tmp_path / "wavs" / "bad.wav").write_bytes(b"RIFFnot a wav file")
    assert tv.find_audio_files(str(tmp_path)) == jv.find_audio_files(str(tmp_path))
    count = tv.vocos_preprocess(str(tmp_path / "wavs"), str(tmp_path / "lists" / "filelist.txt"))
    assert count == 5
    ours = tv.VocosDataset(str(tmp_path / "lists" / "filelist.txt"), 4096, 44100)
    theirs = jv.VocosDataset(str(tmp_path / "lists" / "filelist.txt"), 4096, 44100)
    assert ours.filelist == theirs.filelist and len(ours) == 5
    idx = list(range(5))  # the undecodable clip takes the next one's audio in both
    a = ours.batch(idx, np.random.default_rng(3))
    b = theirs.batch(idx, np.random.default_rng(3))
    assert a.shape == (5, 4096) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    # a clip shorter than the segment is zero-padded
    short = tv.VocosDataset(str(tmp_path / "wavs"), 44100, 44100)
    seg = short.get_segment(1, np.random.default_rng(0))  # clip_0: 0.2 s
    assert seg.shape == (44100,) and np.all(seg[8820:] == 0) and np.any(seg[:8820] != 0)


def test_train_vocos_end_to_end_with_resume(tmp_path):
    _write_wavs(tmp_path / "wavs", 5, MEL.sample_rate, seconds=0.1)
    cfg = VocosTrainConfig(train_dataset_path=str(tmp_path / "wavs"), segment_size=SEGMENT, batch_size=2,
                           num_epochs=2, model_save_path=str(tmp_path / "ck"), log_interval=1, warmup_steps=1,
                           loader_workers=2, prefetch_depth=2)
    logged = []
    state = train_vocos(cfg, VOCOS, MEL, log_fn=lambda step, m: logged.append((step, m)), device="cpu")
    assert (state.step, state.start_epoch) == (4, 0)  # 2 epochs x (5 // 2) steps
    assert [s for s, _ in logged] == [0, 1, 2, 3]
    assert all(len(m) == 11 and np.isfinite(list(m.values())).all() for _, m in logged)
    files = set(os.listdir(tmp_path / "ck"))
    assert {f"{p}_{e}.pt" for p in ("generator", "mpd", "mrd", "optimizerg", "optimizerd") for e in (0, 1)} == files

    # resume: the newest epoch with all five parts, the schedules at the optimizers' counts
    os.remove(tmp_path / "ck" / "mrd_1.pt")
    state = train_vocos(dataclasses.replace(cfg, num_epochs=2), VOCOS, MEL, device="cpu")
    assert (state.start_epoch, state.step) == (1, 4)
    assert state.sched_g.last_epoch == 4 and state.sched_d.last_epoch == 4
    saved = torch.load(tmp_path / "ck" / "generator_1.pt", weights_only=True)
    assert all(torch.equal(v, saved[k]) for k, v in state.gen.state_dict().items())

    # a generator alone is a pretrained start at epoch 0
    for name in os.listdir(tmp_path / "ck"):
        if not name.startswith("generator_"):
            os.remove(tmp_path / "ck" / name)
    state = train_vocos(cfg, VOCOS, MEL, num_epochs=1, device="cpu")
    assert state.start_epoch == 0 and state.step == 2

    with pytest.raises(ValueError):
        train_vocos(dataclasses.replace(cfg, batch_size=64), VOCOS, MEL, device="cpu")
    with pytest.raises(RuntimeError):  # no GPU here, and no silent move to the CPU
        train_vocos(cfg, VOCOS, MEL)
