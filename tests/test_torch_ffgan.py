"""The port's FireflyGAN (stabletts_torch/models/ffgan.py), its conv helpers
(ops/conv.py) and its checkpoint loader against the JAX package on the CPU.
One random state dict in the reference format (weight norm on every conv of
the head, in both serialisations) goes through the JAX package's
`torch_to_flax_ffgan` and through the port's `load_ffgan_state_dict`; the two
models then turn the same mel (<= 16 frames) into the same waveform within
max-abs-err / max-abs-ref <= 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.api import StableTTSAPI
from stabletts_torch.config import MelConfig
from stabletts_torch.models import ffgan as tff
from stabletts_torch.ops import conv as tconv
from stabletts_torch.utils.convert import fold_weight_norm, load_ffgan_state_dict, state_dict_from_jax_ffgan
from stabletts_tpu.models import ffgan as jff
from stabletts_tpu.ops import conv as jconv
from stabletts_tpu.utils import convert as jconvert
from torch_port_utils import MODEL_CFG, TOL, n, t
from torch_port_utils import ffgan_reference_state_dict as _reference_state_dict

torch.set_num_threads(2)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("k,stride", [(16, 8), (4, 2), (7, 3)])
def test_conv_transpose_1d_matches_jax(k, stride):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    kernel = rng.standard_normal((k, 6, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    pad = (k - stride) // 2
    want = np.asarray(jconv.conv_transpose_1d(jnp.asarray(x), jnp.asarray(kernel), stride, pad, jnp.asarray(bias)))
    got = n(tconv.conv_transpose_1d(t(x), t(kernel), stride, pad, t(bias)))
    assert got.shape == want.shape == (2, (11 - 1) * stride - 2 * pad + k, 5)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_conv1d_dilated_matches_jax(k, dilation):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    kernel = rng.standard_normal((k, 6, 4)).astype(np.float32)
    pad = (k * dilation - dilation) // 2
    want = np.asarray(jconv.conv1d_dilated(jnp.asarray(x), jnp.asarray(kernel), dilation, pad))
    np.testing.assert_allclose(n(tconv.conv1d_dilated(t(x), t(kernel), dilation, pad)), want, **TOL)


@pytest.mark.parametrize("k", [1, 3, 4, 5])
def test_conv1d_same_dots_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    kernel = rng.standard_normal((k, 6, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jconv.conv1d_same_dots(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    np.testing.assert_allclose(n(tconv.conv1d_same_dots(t(x), t(kernel), t(bias))), want, **TOL)


def test_config_matches_jax():
    assert tff.FFGAN_CONFIG == jff.FFGAN_CONFIG


def test_drop_path_keeps_the_mean_and_is_off_when_deterministic():
    x = torch.ones(4000, 3)
    assert tff.drop_path(x, 0.2, True) is x and tff.drop_path(x, 0.0, False) is x
    out = tff.drop_path(x, 0.2, False, torch.Generator().manual_seed(0))
    kept = out[:, 0] > 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.8)) and abs(float(kept.float().mean()) - 0.8) < 0.03


@pytest.fixture(scope="module")
def both():
    sd = _reference_state_dict()
    params = jconvert.torch_to_flax_ffgan({k: v for k, v in sd.items() if "num_batches" not in k})
    ours = tff.FireflyGANBase(device="cpu")
    ours.load_state_dict(load_ffgan_state_dict(sd))
    return sd, params, ours.eval()


def test_fold_weight_norm_matches_jax(both):
    sd, _, _ = both
    prefix = next(k[: -len(".weight_g")] for k in sd if k.endswith(".weight_g"))
    g, v = sd[prefix + ".weight_g"], sd[prefix + ".weight_v"]
    np.testing.assert_allclose(n(fold_weight_norm(t(g), t(v))), jconvert.fold_weight_norm(g, v), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("frames", [16, 5])
def test_ffgan_matches_jax_from_one_reference_state_dict(both, frames):
    _, params, ours = both
    rng = np.random.default_rng(frames)
    mel = rng.standard_normal((2, frames, 128)).astype(np.float32)
    want = np.asarray(jff.FireflyGANBase().apply({"params": params}, jnp.asarray(mel)))
    got = n(ours(t(mel)))
    assert got.shape == want.shape == (2, frames * 512)
    assert np.abs(want).max() > 1e-3 and np.abs(got).max() <= 1.0
    assert _rel(got, want) <= 1e-3


def test_state_dict_from_jax_ffgan_round_trip(both):
    """JAX params -> the port's state dict gives the loader's folded state
    dict back, key for key."""
    sd, params, ours = both
    want = load_ffgan_state_dict(sd)
    got = state_dict_from_jax_ffgan(params)
    assert set(got) == set(want) == set(ours.state_dict())
    for key in want:
        np.testing.assert_allclose(n(got[key]), n(want[key]), rtol=1e-6, atol=1e-7, err_msg=key)


def test_api_with_ffgan_end_to_end_on_the_cpu(both, tmp_path):
    """StableTTSAPI(vocoder_name="ffgan") from a checkpoint file in the
    reference format: waveform length = frames * 512, finite, within [-1, 1];
    batch_inference trims each item."""
    sd, _, ours = both
    path = str(tmp_path / "ffgan.ckpt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    api = StableTTSAPI(vocoder_model_path=path, vocoder_name="ffgan", model_config=MODEL_CFG,
                       mel_config=MelConfig(), max_mel_len=256, device="cpu")
    for key, value in ours.state_dict().items():
        torch.testing.assert_close(api.vocoder_model.state_dict()[key], value)
    rng = np.random.default_rng(1)
    ref = (0.1 * rng.standard_normal(22050)).astype(np.float32)
    wav, mel = api.inference("Hello there, world.", ref, "english", step=2, cfg=2.0, solver="midpoint")
    assert mel.shape[1] == 128 and wav.shape == (1, mel.shape[2] * 512)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    wavs = api.batch_inference([("Hello.", "english"), ("Good morning to you all.", "english")], ref, step=1, cfg=1.0)
    assert len(wavs) == 2 and all(w.shape[0] % 512 == 0 and np.isfinite(w).all() for w in wavs)
    assert wavs[0].shape[0] < wavs[1].shape[0]
    with pytest.raises(ValueError, match="vocoder"):
        StableTTSAPI(vocoder_name="hifigan", device="cpu")
