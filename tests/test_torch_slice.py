"""The whole serving path, text ids -> mel -> waveform, through both
packages on the CPU: `synthesise` (4 Euler steps, CFG on and off, shared
numpy noise) and then Vocos, at the small config with adaLN randomised.
y_lengths and y_clamped must be equal; mel and waveform within
max-abs-error / max-abs-reference <= 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.models.sampler import synthesise
from stabletts_torch.ops.ode import odeint
from stabletts_tpu.models.sampler import synthesise as jsynthesise
from stabletts_tpu.ops.ode import odeint_fixed
from torch_port_utils import MEL_CFG, jax_stabletts, jax_vocos, n, port_stabletts, port_vocos, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jmodel, params = jax_stabletts(seed=3)
    jvocos, vparams = jax_vocos(seed=4)
    return jmodel, params, port_stabletts(params), jvocos, vparams, port_vocos(vparams)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("cfg", [3.0, 1.0])
def test_synthesise_and_vocode_match_jax(models, cfg):
    jmodel, params, ours, jvocos, vparams, our_vocos = models
    rng = np.random.default_rng(11)
    b, max_len = 2, 70
    x = rng.integers(1, 400, size=(b, 17))
    x_lengths = np.asarray([17, 11])
    x[1, 11:] = 0
    noise = rng.standard_normal((b, max_len, MEL_CFG.n_mels)).astype(np.float32)
    y_ref = rng.standard_normal((b, 25, MEL_CFG.n_mels)).astype(np.float32)
    kw = dict(n_timesteps=4, cfg=cfg, max_mel_len=max_len)

    want = jsynthesise(jmodel, {"params": params}, jnp.asarray(x), jnp.asarray(x_lengths), jnp.asarray(noise),
                       jnp.asarray(y_ref), **kw)
    got = synthesise(ours, x, x_lengths, noise, y_ref, device="cpu", **kw)
    np.testing.assert_array_equal(n(got["y_lengths"]), np.asarray(want["y_lengths"]))
    np.testing.assert_array_equal(n(got["y_clamped"]), np.asarray(want["y_clamped"]))
    mel, jmel = n(got["decoder_outputs"]), np.asarray(want["decoder_outputs"])
    assert mel.shape == jmel.shape == (b, max_len, MEL_CFG.n_mels)
    assert _rel(mel, jmel) <= 1e-3

    lengths = np.asarray(want["y_lengths"])
    wav = n(our_vocos(t(jmel), t(lengths)))
    jwav = np.asarray(jvocos.apply({"params": vparams}, jnp.asarray(jmel), jnp.asarray(lengths)))
    assert _rel(wav, jwav) <= 1e-3
    # and the port's own mel through the port's vocoder against JAX end to end
    assert _rel(n(our_vocos(got["decoder_outputs"], got["y_lengths"])), jwav) <= 1e-3


def test_euler_matches_jax_grid():
    f = lambda tt, y: -2.0 * y + tt
    y0 = np.ones((2, 3), np.float32)
    for steps in (1, 4, 10):
        span = torch.linspace(0.0, 1.0, steps + 1)
        ours = n(odeint(f, t(y0), span))
        want = np.asarray(odeint_fixed(f, jnp.asarray(y0), jnp.linspace(0.0, 1.0, steps + 1)))
        np.testing.assert_allclose(ours, want, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown solver"):
        odeint(f, t(y0), torch.linspace(0.0, 1.0, 3), method="rk5")


def test_synthesise_bf16_runs_and_trims(models):
    _, _, ours, _, _, _ = models
    rng = np.random.default_rng(12)
    out = synthesise(ours, rng.integers(1, 400, (1, 9)), [9], rng.standard_normal((1, 300, MEL_CFG.n_mels)),
                     rng.standard_normal((1, 20, MEL_CFG.n_mels)), n_timesteps=2, cfg=2.0, max_mel_len=300,
                     compute_dtype=torch.bfloat16, device="cpu")
    assert out["decoder_outputs"].dtype == torch.float32 and out["decoder_outputs"].shape == (1, 300, 32)
    assert torch.isfinite(out["decoder_outputs"]).all()
    assert next(ours.parameters()).dtype == torch.float32  # the caller's model is not cast


def test_synthesise_without_device_needs_a_gpu(models):
    _, _, ours, _, _, _ = models
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None selects it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthesise(ours, [[1, 2]], [2], np.zeros((1, 8, 32)), np.zeros((1, 8, 32)), max_mel_len=8)
