"""The port's native host library (stabletts_torch/native) against the JAX
package's: `load_and_resample_audio` and `VocosDataset.get_segment` of both
packages on the same seeded files. Both libraries are built from the same C++
with the same flags, so the outputs agree within 1e-6 (in practice bit for
bit); scipy's polyphase resampler, the port's fallback, differs by ~4e-2.

The JAX package's loader compiles its library in place, next to its sources,
when the library is older than them; a process that opens the file while
another one rewrites it falls back to scipy for the rest of its life. So this
module builds the JAX package's library into a private file of its own."""

import os

import numpy as np
import pytest
from scipy.io import wavfile

import stabletts_tpu.native as jax_native

from stabletts_torch.data.vocos_dataset import VocosDataset
from stabletts_torch.native import get_lib as port_lib
from stabletts_torch.utils.audio_io import load_and_resample_audio
from stabletts_tpu.data.vocos_dataset import VocosDataset as JVocosDataset
from stabletts_tpu.native import get_lib as jax_lib
from stabletts_tpu.utils.audio_io import load_and_resample_audio as jload_and_resample_audio
from tests.flac_writer import encode_flac

BAR = 1e-6
TARGET_SR = 44100


def _noise_pcm16(sr: int, seconds: float = 1.0, seed: int = 0) -> np.ndarray:
    """Seeded noise at 0.2 rms as int16 samples."""
    rng = np.random.default_rng(seed + sr)
    return np.clip(0.2 * rng.standard_normal(int(seconds * sr)) * 32768, -32768, 32767).astype(np.int16)


def _write_wav(tmp_path, sr: int, seconds: float = 1.0) -> str:
    path = str(tmp_path / f"noise_{sr}.wav")
    wavfile.write(path, sr, _noise_pcm16(sr, seconds))
    return path


@pytest.fixture(scope="module", autouse=True)
def private_jax_lib(tmp_path_factory):
    """Points the JAX package's loader at a private library path: its own
    `_build` compiles its sources there, with its own flags, on first use and
    no other process reads or writes that file. The three attributes are
    restored afterwards."""
    path = str(tmp_path_factory.mktemp("jax_native") / "libstabletts_native.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", path)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        yield path


def test_both_packages_take_the_native_path(private_jax_lib):
    lib = jax_lib()
    assert lib is not None
    assert os.path.samefile(lib._name, private_jax_lib)
    assert port_lib() is not None


@pytest.mark.parametrize("sr", [16000, 22050, 24000, 48000, 44100])
def test_load_and_resample_wav_matches_jax(tmp_path, sr):
    assert jax_lib() is not None
    path = _write_wav(tmp_path, sr)
    want = jload_and_resample_audio(path, TARGET_SR)
    got = load_and_resample_audio(path, TARGET_SR)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and abs(got.shape[0] - TARGET_SR) <= 2
    assert np.abs(want).max() > 0.1
    assert float(np.abs(got - want).max()) <= BAR


def test_load_and_resample_flac_matches_jax(tmp_path):
    assert jax_lib() is not None
    sr = 22050
    path = str(tmp_path / "noise.flac")
    with open(path, "wb") as f:
        f.write(encode_flac(_noise_pcm16(sr), sr))
    want = jload_and_resample_audio(path, TARGET_SR)
    got = load_and_resample_audio(path, TARGET_SR)
    assert got is not None and got.shape == want.shape and abs(got.shape[0] - TARGET_SR) <= 2
    assert float(np.abs(got - want).max()) <= BAR


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sr", [22050, 48000])
def test_vocos_segment_matches_jax(tmp_path, sr, seed):
    """Random crops (segment 8192 of 1.5 s resampled to 44.1 kHz) at the
    same seeded start fractions, and one segment longer than the file."""
    assert jax_lib() is not None
    _write_wav(tmp_path, sr, seconds=1.5)
    for segment in (8192, 100000):
        ours = VocosDataset(str(tmp_path), segment, TARGET_SR)
        theirs = JVocosDataset(str(tmp_path), segment, TARGET_SR)
        rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            got, want = ours.get_segment(0, rng_a), theirs.get_segment(0, rng_b)
            assert got.shape == want.shape == (segment,)
            assert np.abs(want).max() > 0.1
            assert float(np.abs(got - want).max()) <= BAR
