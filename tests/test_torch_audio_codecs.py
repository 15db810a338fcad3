"""The port's audio decoders against the JAX package's: FLAC (written by
tests/flac_writer.py in every subframe and stereo mode), mp3 (the JAX
package's test-only libmp3lame binding) and Ogg Vorbis (libvorbisenc, as
tests/torch_codec_fixtures.py writes it), all from a seed. `load_audio` must
give the JAX `load_audio`'s samples and rate bit for bit, and so must
`load_and_resample_audio` where both take the Python decoders."""

import ctypes.util

import numpy as np
import pytest
import torch

from flac_writer import encode_flac
from stabletts_torch.utils import audio_io
from torch_codec_fixtures import MP3_LIBS, OGG_LIBS, have, write_ogg

torch.set_num_threads(2)

needs_mp3 = pytest.mark.skipif(not have(*MP3_LIBS), reason="libmpg123 or libmp3lame not found")
needs_ogg = pytest.mark.skipif(not have(*OGG_LIBS), reason="libvorbisfile or libvorbisenc not found")


def _signal(sr, seconds=0.5, seed=0, channels=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    waves = [0.4 * np.sin(2 * np.pi * (220 + 110 * c) * t) + 0.05 * rng.standard_normal(t.size)
             for c in range(channels)]
    wav = np.stack(waves, axis=1) if channels > 1 else waves[0]
    return np.clip(wav, -1, 1).astype(np.float32)


def _same(path):
    from stabletts_tpu.utils.audio_io import load_audio as jload

    wav, sr = audio_io.load_audio(path)
    jwav, jsr = jload(path)
    assert sr == jsr and wav.dtype == jwav.dtype and wav.shape == jwav.shape
    assert np.array_equal(wav, jwav)
    return wav, sr


@pytest.mark.parametrize("mode", ["verbatim", "fixed2", "lpc2", "escape", "wasted", "constant"])
@pytest.mark.parametrize("sr", [22050, 44100])
def test_flac_decodes_as_jax(tmp_path, mode, sr):
    rng = np.random.default_rng(7)
    if mode == "constant":
        pcm = np.full(3000, 1234, dtype=np.int64)
    else:
        pcm = (_signal(sr, seed=sr) * 30000).astype(np.int64)
        if mode == "wasted":
            pcm &= ~3
        elif mode == "escape":
            pcm[rng.integers(0, pcm.size, 50)] = 32767
    path = tmp_path / "a.flac"
    path.write_bytes(encode_flac(pcm, sr, mode=mode, block_size=1024))
    wav, got_sr = _same(str(path))
    assert got_sr == sr and np.array_equal(wav, pcm.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("stereo_mode", ["indep", "left_side", "right_side", "mid_side"])
def test_flac_stereo_decodes_as_jax(tmp_path, stereo_mode):
    pcm = (_signal(44100, seed=3, channels=2) * 30000).astype(np.int64)
    path = tmp_path / "s.flac"
    path.write_bytes(encode_flac(pcm, 44100, mode="fixed2", stereo_mode=stereo_mode))
    wav, _ = _same(str(path))
    assert np.array_equal(wav, pcm[:, 0].astype(np.float32) / 32768.0)  # mono via the first channel


@needs_mp3
@pytest.mark.parametrize("sr,channels", [(24000, 1), (44100, 1), (44100, 2)])
def test_mp3_decodes_as_jax(tmp_path, sr, channels):
    from stabletts_tpu.utils.codecs import encode_mp3

    path = str(tmp_path / "a.mp3")
    encode_mp3(_signal(sr, seed=sr + channels, channels=channels), sr, path)
    wav, got_sr = _same(path)
    assert got_sr == sr and wav.ndim == 1 and len(wav) >= int(sr * 0.5)


@needs_ogg
@pytest.mark.parametrize("sr", [22050, 44100])
def test_ogg_decodes_as_jax(tmp_path, sr):
    path = str(tmp_path / "a.ogg")
    wave = _signal(sr, seed=sr + 1)
    write_ogg(path, wave, sr)
    wav, got_sr = _same(path)
    assert got_sr == sr and len(wav) == len(wave)
    assert np.corrcoef(wav, wave)[0, 1] > 0.98  # lossy, no delay


@pytest.mark.parametrize("fmt", [pytest.param("mp3", marks=needs_mp3), pytest.param("ogg", marks=needs_ogg)])
def test_load_and_resample_matches_jax(tmp_path, fmt):
    """mp3 and ogg go through the Python decoders and scipy's resampling in
    both packages (the native loaders read WAV and FLAC alone)."""
    from stabletts_tpu.utils.audio_io import load_and_resample_audio as jload
    from stabletts_tpu.utils.codecs import encode_mp3

    path = str(tmp_path / f"a.{fmt}")
    wave = _signal(44100, seed=11)
    if fmt == "mp3":
        encode_mp3(wave, 44100, path)
    else:
        write_ogg(path, wave, 44100)
    got, want = audio_io.load_and_resample_audio(path, 24000), jload(path, 24000)
    assert got is not None and np.array_equal(got, want)


def test_unknown_format_names_every_decodable_one(tmp_path):
    path = tmp_path / "bogus.xyz"
    path.write_bytes(b"\x00\x01\x02\x03 not audio")
    with pytest.raises(ValueError, match="WAV, FLAC, mp3 and ogg"):
        audio_io.load_audio(str(path))
    assert audio_io.load_and_resample_audio(str(path), 24000) is None


@pytest.mark.skipif(not ctypes.util.find_library("vorbisfile"), reason="libvorbisfile not found")
def test_corrupt_ogg_raises(tmp_path):
    path = tmp_path / "corrupt.ogg"
    path.write_bytes(b"OggS" + b"\x00" * 64)
    with pytest.raises(RuntimeError):
        audio_io.load_audio(str(path))


def test_chip_smoke_reference_formats_on_cpu(tmp_path):
    """chip_smoke.py's reference-format check, run here on the CPU API: FLAC's
    reference mel equals the WAV's, and mp3 and ogg (where their libraries
    are found) keep the lossy bar."""
    import chip_smoke
    from stabletts_torch.api import StableTTSAPI
    from torch_port_utils import MEL_CFG, MODEL_CFG, VOCOS_CFG

    api = StableTTSAPI(model_config=MODEL_CFG, mel_config=MEL_CFG, vocos_config=VOCOS_CFG, device="cpu")
    rows = chip_smoke.reference_formats(api, str(tmp_path), chip_smoke.reference_wave(9, seconds=1.0,
                                                                                       sr=MEL_CFG.sample_rate))
    assert [r["format"] for r in rows] == ["flac", "mp3", "ogg"] and all(r["ok"] for r in rows), rows
    assert rows[0]["decoded"] and rows[0]["mel_max_abs_err_vs_wav"] == 0.0
    assert [r["decoded"] for r in rows[1:]] == [have(*MP3_LIBS), have(*OGG_LIBS)]
