"""stabletts_torch.api against the JAX package's API on the CPU: phoneme ids,
the reference log-mel, sentence splitting, and the shapes that inference,
batch_inference and inference_long return with the same weights, in every
language the API maps and from a reference file in each decodable format."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.api import StableTTSAPI
from stabletts_torch.config import MelConfig
from stabletts_torch.ops.stft import log_mel_spectrogram, mel_filterbank
from stabletts_torch.text import cleaned_text_to_sequence, intersperse
from stabletts_torch.text.english import english_to_ipa2
from stabletts_torch.utils.convert import state_dict_from_jax_stabletts, state_dict_from_jax_vocos
from torch_port_utils import MEL_CFG, MODEL_CFG, VOCOS_CFG, jax_configs, n

torch.set_num_threads(2)

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Dr. Smith paid $5.20 for 3 apples on March 4th, 2021!",
    "Isn't it wonderful? She said: \"yes\", twice.",
    "NASA's 2nd launch window opens at 10:45 pm.",
]


def _wave(seconds=1.0, sr=44100, seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.01 * rng.standard_normal(tt.size)).astype(np.float32)


@pytest.mark.parametrize("text", SENTENCES)
def test_phoneme_ids_match_jax(text):
    from stabletts_tpu.text import cleaned_text_to_sequence as jseq
    from stabletts_tpu.text import intersperse as jinter
    from stabletts_tpu.text.english import english_to_ipa2 as jg2p

    assert intersperse(cleaned_text_to_sequence(english_to_ipa2(text)), 0) == jinter(jseq(jg2p(text)), 0)


@pytest.mark.parametrize("cfg", [MelConfig(), MEL_CFG])
def test_log_mel_matches_jax(cfg):
    from stabletts_tpu.ops import stft as jstft

    _, jcfg, _ = jax_configs(mel_cfg=cfg)
    wav = _wave(0.5, cfg.sample_rate)
    want = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(wav)[None, :], jcfg))
    got = n(log_mel_spectrogram(torch.from_numpy(wav)[None, :], cfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels),
                                  jstft.mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels))


def test_split_sentences_matches_jax():
    from stabletts_tpu.api import StableTTSAPI as JAPI

    text = " ".join(SENTENCES * 3) + " " + "word " * 80
    for max_chars in (20, 60, 300):
        assert StableTTSAPI._split_sentences(text, max_chars) == JAPI._split_sentences(text, max_chars)


@pytest.fixture(scope="module")
def apis():
    from stabletts_tpu.api import StableTTSAPI as JAPI

    jm, jmel, jvoc = jax_configs()
    japi = JAPI(vocoder_name="vocos", model_config=jm, mel_config=jmel, vocos_config=jvoc, max_mel_len=256)
    ours = StableTTSAPI(model_config=MODEL_CFG, mel_config=MEL_CFG, vocos_config=VOCOS_CFG, max_mel_len=256,
                        device="cpu")
    ours.tts_model.load_state_dict(state_dict_from_jax_stabletts(
        japi.tts_variables["params"], MODEL_CFG.n_enc_layers, MODEL_CFG.n_dec_layers))
    ours.vocoder_model.load_state_dict(state_dict_from_jax_vocos(
        japi.vocoder_variables["params"], VOCOS_CFG.num_layers))
    return japi, ours


def test_inference_shapes_match_jax(apis):
    japi, ours = apis
    ref = _wave(seed=1)
    kw = dict(step=1, cfg=1.0)
    jwav, jmel = japi.inference(SENTENCES[0], ref, "english", **kw)
    wav, mel = ours.inference(SENTENCES[0], ref, "english", **kw)
    assert wav.shape == jwav.shape and mel.shape == jmel.shape
    assert mel.shape[1] == MEL_CFG.n_mels and wav.shape[1] == mel.shape[2] * MEL_CFG.hop_length
    assert np.isfinite(wav).all()


def test_batch_and_long_inference_shapes_match_jax(apis):
    japi, ours = apis
    ref = _wave(seed=2)
    kw = dict(step=1, cfg=1.0)
    items = [(s, "english") for s in SENTENCES[:2]]
    jwavs = japi.batch_inference(items, ref, **kw)
    wavs = ours.batch_inference(items, ref, **kw)
    assert [w.shape for w in wavs] == [w.shape for w in jwavs]
    text = " ".join(SENTENCES[:2])
    jwav, jmel = japi.inference_long(text, ref, "english", max_chars_per_chunk=60, **kw)
    wav, mel = ours.inference_long(text, ref, "english", max_chars_per_chunk=60, **kw)
    assert wav.shape == jwav.shape and mel.shape == jmel.shape


def test_api_rejects_what_this_port_lacks(apis):
    _, ours = apis
    with pytest.raises(ValueError, match="english"):
        ours.inference("x", _wave(0.1), "klingon")
    with pytest.raises(ValueError, match="could not load"):  # a path is read as a WAV file; this one is missing
        ours.inference("hello", "/some/file.wav", "english")
    tts_m, voc_m = StableTTSAPI(device="cpu").get_params()
    assert 31 < tts_m < 33  # the 31M flagship
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StableTTSAPI()


def test_api_reads_a_wav_path_as_the_reference(apis, tmp_path):
    """A WAV path as `ref_audio` gives what the decoded waveform gives, as in
    the JAX API."""
    from stabletts_torch.utils.audio_io import load_audio, save_wav

    _, ours = apis
    path = str(tmp_path / "ref.wav")
    save_wav(path, _wave(seed=5), ours.mel_config.sample_rate)
    decoded, sr = load_audio(path)
    assert sr == ours.mel_config.sample_rate
    kw = dict(step=1, cfg=1.0, seed=2)
    wav_path, mel_path = ours.inference(SENTENCES[0], path, "english", **kw)
    wav_arr, mel_arr = ours.inference(SENTENCES[0], decoded, "english", **kw)
    assert np.array_equal(mel_path, mel_arr) and np.array_equal(wav_path, wav_arr)


def test_shape_ladder_pads_and_keeps_lengths(apis):
    _, ours = apis
    ladder = StableTTSAPI(model_config=MODEL_CFG, mel_config=MEL_CFG, vocos_config=VOCOS_CFG, max_mel_len=256,
                          device="cpu")
    ladder.tts_model.load_state_dict(ours.tts_model.state_dict())
    ladder.vocoder_model.load_state_dict(ours.vocoder_model.state_dict())
    ladder._shape_ladder = True
    ref = _wave(seed=3)
    wav, mel = ours.inference(SENTENCES[2], ref, "english", step=1, cfg=1.0)
    wav_l, mel_l = ladder.inference(SENTENCES[2], ref, "english", step=1, cfg=1.0)
    assert wav.shape == wav_l.shape and mel.shape == mel_l.shape
    assert dataclasses.asdict(ladder.mel_config) == dataclasses.asdict(MEL_CFG)


@pytest.fixture(scope="module")
def ffgan_checkpoint(tmp_path_factory):
    from torch_port_utils import ffgan_reference_state_dict

    path = str(tmp_path_factory.mktemp("vocoder") / "ffgan.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in ffgan_reference_state_dict(seed=3).items()}, path)
    return path


@pytest.mark.parametrize("with_path", [True, False])
@pytest.mark.parametrize("name", [None, "ffgan"])
def test_vocoder_choice_matches_jax(ffgan_checkpoint, name, with_path):
    """{default name, "ffgan"} x {checkpoint, none}: the same vocoder class as
    the JAX API (a checkpoint is read as the named vocoder, FireflyGAN by
    default; with none, a random Vocos whatever the name), and where a
    checkpoint is loaded, the same waveform from the same mel."""
    from stabletts_tpu.api import StableTTSAPI as JAPI

    jm, _, jvoc = jax_configs()
    kw = {} if name is None else {"vocoder_name": name}
    if with_path:
        kw["vocoder_model_path"] = ffgan_checkpoint
    japi = JAPI(model_config=jm, vocos_config=jvoc, max_mel_len=256, **kw)
    ours = StableTTSAPI(model_config=MODEL_CFG, vocos_config=VOCOS_CFG, max_mel_len=256, device="cpu", **kw)
    assert type(ours.vocoder_model).__name__ == type(japi.vocoder_model).__name__
    assert type(ours.vocoder_model).__name__ == ("FireflyGANBase" if with_path else "Vocos")
    assert ours._vocoder_supports_lengths == japi._vocoder_supports_lengths
    if with_path:
        mel = np.random.default_rng(4).standard_normal((1, 12, 128)).astype(np.float32)
        want = np.asarray(japi.vocoder_model.apply(japi.vocoder_variables, jnp.asarray(mel)))
        got = n(ours.vocoder_model(torch.from_numpy(mel)))
        assert got.shape == want.shape == (1, 12 * 512)
        assert float(np.abs(got - want).max() / np.abs(want).max()) <= 1e-3


# a sentence per non-English language of the API's map
LANGUAGE_SENTENCES = {"chinese": "今天天气很好，我们一起去公园散步吧。", "japanese": "明日の朝八時に駅で会いましょう",
                      "auto": "今日の会議はZoomで行います。Hello 世界, this is mixed text."}


def test_api_maps_the_languages_of_jax(apis):
    japi, ours = apis
    assert list(ours.supported_languages) == list(japi.supported_languages) == ["chinese", "japanese", "english", "auto"]
    from stabletts_tpu.text import cleaned_text_to_sequence as jseq
    from stabletts_tpu.text import intersperse as jinter

    for lang, text in LANGUAGE_SENTENCES.items():
        ids = ours._phonemes(text, lang)
        assert ids == jinter(jseq(japi.g2p_mapping[lang](text)), 0) and len(ids) > 10


@pytest.mark.parametrize("lang", list(LANGUAGE_SENTENCES))
def test_inference_in_each_language_matches_jax_shapes(apis, lang):
    japi, ours = apis
    ref = _wave(seed=6)
    kw = dict(step=1, cfg=1.0)
    jwav, jmel = japi.inference(LANGUAGE_SENTENCES[lang], ref, lang, **kw)
    wav, mel = ours.inference(LANGUAGE_SENTENCES[lang], ref, lang, **kw)
    assert wav.shape == jwav.shape and mel.shape == jmel.shape
    assert wav.shape[1] == mel.shape[2] * MEL_CFG.hop_length and np.isfinite(wav).all()


@pytest.mark.parametrize("fmt", ["flac", "mp3", "ogg"])
def test_api_reads_a_compressed_reference(apis, tmp_path, fmt):
    """A FLAC, mp3 or ogg path as `ref_audio`: the JAX API's output shapes, and
    for lossless FLAC what the same clip's WAV path gives, bit for bit."""
    import torch_codec_fixtures as fx
    from stabletts_torch.utils.audio_io import save_wav

    libs = {"flac": (), "mp3": fx.MP3_LIBS, "ogg": fx.OGG_LIBS}[fmt]
    if not fx.have(*libs):
        pytest.skip(f"{fmt} codec libraries not found")
    japi, ours = apis
    sr = ours.mel_config.sample_rate
    wave = _wave(seed=8, sr=sr)
    wav_path, path = str(tmp_path / "ref.wav"), str(tmp_path / f"ref.{fmt}")
    save_wav(wav_path, wave, sr)
    getattr(fx, f"write_{fmt}")(path, wave, sr)
    kw = dict(step=1, cfg=1.0, seed=4)
    text = LANGUAGE_SENTENCES["japanese"]
    wav, mel = ours.inference(text, path, "japanese", **kw)
    jwav, jmel = japi.inference(text, path, "japanese", **kw)
    assert wav.shape == jwav.shape and mel.shape == jmel.shape and np.isfinite(wav).all()
    if fmt == "flac":
        wav_w, mel_w = ours.inference(text, wav_path, "japanese", **kw)
        assert np.array_equal(mel, mel_w) and np.array_equal(wav, wav_w)
