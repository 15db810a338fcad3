"""stabletts_torch's StableTTS modules against the JAX package on the CPU at a
small config (2 heads of 64, F=128, 1 encoder / 2 decoder layers, 32 mels),
with the same numpy inputs and the JAX weights carried across by
state_dict_from_jax_stabletts. adaLN is randomised. fp32 bar 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.models.stabletts import generate_path
from stabletts_tpu.models.stabletts import StableTTS as JStableTTS
from stabletts_tpu.models.stabletts import generate_path as jgenerate_path
from torch_port_utils import MEL_CFG, TOL, jax_stabletts, n, port_stabletts, t

torch.set_num_threads(2)
N_MELS = MEL_CFG.n_mels


@pytest.fixture(scope="module")
def pair():
    jmodel, params = jax_stabletts()
    return jmodel, {"params": params}, port_stabletts(params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    x = rng.integers(1, 400, size=(2, 23))
    x_lengths = np.asarray([23, 14])
    x[1, 14:] = 0
    y_ref = rng.standard_normal((2, 31, N_MELS)).astype(np.float32)
    ref_mask = (np.arange(31)[None, :] < np.asarray([31, 20])[:, None]).astype(np.float32)
    return x, x_lengths, y_ref, ref_mask


def _apply(jmodel, variables, fn, *args):
    return jmodel.apply(variables, *args, method=fn)


@pytest.mark.parametrize("masked", [False, True])
def test_ref_encoder(pair, inputs, masked):
    jmodel, variables, ours = pair
    _, _, y_ref, ref_mask = inputs
    m = ref_mask if masked else None
    want = _apply(jmodel, variables, lambda mod, y, mk: mod.ref_encoder(y, mk, True),
                  jnp.asarray(y_ref), None if m is None else jnp.asarray(m))
    got = ours.ref_encoder(t(y_ref), None if m is None else t(m))
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_text_encoder_and_duration_predictor(pair, inputs):
    jmodel, variables, ours = pair
    x, x_lengths, y_ref, _ = inputs
    c = np.random.default_rng(1).standard_normal((2, 256)).astype(np.float32)

    def jfn(mod, x, c, xl):
        h, mu, mask = mod.encoder(x, c, xl, True)
        return h, mu, mask, mod.dp(h, mask, c, True)

    jh, jmu, jmask, jlogw = _apply(jmodel, variables, jfn, jnp.asarray(x), jnp.asarray(c), jnp.asarray(x_lengths))
    h, mu, mask = ours.encoder(t(x), t(c), t(x_lengths))
    logw = ours.dp(h, mask, t(c))
    valid = np.asarray(jmask) > 0
    np.testing.assert_array_equal(n(mask), np.asarray(jmask))
    np.testing.assert_allclose(n(h)[valid], np.asarray(jh)[valid], **TOL)
    np.testing.assert_allclose(n(mu), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(n(logw), np.asarray(jlogw), **TOL)


def test_generate_path_matches_jax():
    rng = np.random.default_rng(2)
    dur = np.ceil(rng.uniform(0, 3, (2, 9))).astype(np.float32)
    mask = np.ones((2, 9, 30), np.float32)
    mask[1, 6:] = 0
    np.testing.assert_array_equal(n(generate_path(t(dur), t(mask))),
                                  np.asarray(jgenerate_path(jnp.asarray(dur), jnp.asarray(mask))))


@pytest.mark.parametrize("length_scale", [1.0, 1.5])  # exact in binary: equal cumsums
def test_prepare_synthesis(pair, inputs, length_scale):
    jmodel, variables, ours = pair
    x, x_lengths, y_ref, ref_mask = inputs
    args = (100, length_scale, None, 90)
    want = _apply(jmodel, variables, JStableTTS.prepare_synthesis, jnp.asarray(x), jnp.asarray(x_lengths),
                  jnp.asarray(y_ref), *args)
    got = ours.prepare_synthesis(t(x), t(x_lengths), t(y_ref), *args)
    np.testing.assert_array_equal(n(got["y_lengths"]), np.asarray(want["y_lengths"]))
    np.testing.assert_array_equal(n(got["y_clamped"]), np.asarray(want["y_clamped"]))
    np.testing.assert_array_equal(n(got["attn"]), np.asarray(want["attn"]))
    np.testing.assert_allclose(n(got["mu_y"]), np.asarray(want["mu_y"]), **TOL)
    np.testing.assert_allclose(n(got["c"]), np.asarray(want["c"]), **TOL)


def test_prepare_synthesis_flags_clamped_lengths(pair, inputs):
    _, _, ours = pair
    x, x_lengths, y_ref, _ = inputs
    got = ours.prepare_synthesis(t(x), t(x_lengths), t(y_ref), 16, 4.0, None, 8)
    assert bool(got["y_clamped"].all()) and n(got["y_lengths"]).tolist() == [8, 8]


@pytest.mark.parametrize("cfg", [1.0, 2.5])
def test_velocity_with_precomputed_mu(pair, cfg):
    """One estimator evaluation, CFG off (velocity) and on (one [2B] call)."""
    jmodel, variables, ours = pair
    rng = np.random.default_rng(3)
    b, tl, valid = 2, 40, 33
    mu = rng.standard_normal((b, tl, N_MELS)).astype(np.float32)
    xt = rng.standard_normal((b, tl, N_MELS)).astype(np.float32)
    mask = (np.arange(tl)[None, :] < np.asarray([valid, 21])[:, None]).astype(np.float32)
    c = rng.standard_normal((b, 256)).astype(np.float32)
    tt = np.asarray([0.3, 0.3], np.float32)
    jh = _apply(jmodel, variables, JStableTTS.precompute_mu, jnp.asarray(mu))
    h = ours.precompute_mu(t(mu))
    np.testing.assert_allclose(n(h), np.asarray(jh), **TOL)
    if cfg == 1.0:
        want = _apply(jmodel, variables, JStableTTS.velocity, jnp.asarray(tt), jnp.asarray(xt), jnp.asarray(mask),
                      jh, jnp.asarray(c), True)
        got = ours.velocity(t(tt), t(xt), t(mask), h, t(c), True)
    else:
        jfake = _apply(jmodel, variables, JStableTTS.precompute_fake_mu, b, tl, valid)
        fake = ours.precompute_fake_mu(b, tl, valid)
        np.testing.assert_allclose(n(fake), np.asarray(jfake), **TOL)
        want = _apply(jmodel, variables, JStableTTS.cfg_velocity, jnp.asarray(tt), jnp.asarray(xt),
                      jnp.asarray(mask), jh, jnp.asarray(c), cfg, jfake, True)
        got = ours.cfg_velocity(t(tt), t(xt), t(mask), h, t(c), cfg, fake, True)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)


def test_cfg_velocity_rejects_raw_fake_mu_with_precomputed(pair):
    _, _, ours = pair
    z = torch.zeros(1, 8, N_MELS)
    with pytest.raises(ValueError, match="precomputed"):
        ours.cfg_velocity(torch.zeros(1), z, torch.ones(1, 8), torch.zeros(1, 8, 128), torch.zeros(1, 256), 2.0,
                          None, True)
