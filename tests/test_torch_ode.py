"""stabletts_torch.ops.ode against the JAX package's `ops/ode.py` on the same
linear and nonlinear test systems, and `synthesise` with a non-Euler solver
against the JAX sampler. Bars: fixed-grid solvers 1e-5, adaptive solvers 1e-4
(their step sequences must agree for that), the sampler 1e-3 of the largest
value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.models.sampler import synthesise
from stabletts_torch.ops import ode as tode
from stabletts_tpu.models.sampler import synthesise as jsynthesise
from stabletts_tpu.ops import ode as jode
from torch_port_utils import MEL_CFG, jax_stabletts, n, port_stabletts, t

torch.set_num_threads(2)

Y0 = np.asarray([[1.0, -0.5, 2.0], [0.3, 1.5, -1.0]], np.float32)
A = np.asarray([[-1.0, 0.5, 0.0], [-0.5, -1.0, 0.3], [0.0, -0.3, -2.0]], np.float32)

# (JAX field, torch field): a linear system with rotation and decay, and a
# nonlinear one with a time-dependent rate
SYSTEMS = {
    "linear": (lambda tt, y: y @ jnp.asarray(A), lambda tt, y: y @ t(A).to(y.dtype)),
    "nonlinear": (lambda tt, y: jnp.cos(3.0 * tt) * y - 0.5 * y ** 3 + tt,
                  lambda tt, y: torch.cos(3.0 * tt) * y - 0.5 * y ** 3 + tt),
}


def test_solver_lists_match_jax():
    assert tode.FIXED_SOLVERS == jode.FIXED_SOLVERS and tode.ADAPTIVE_SOLVERS == jode.ADAPTIVE_SOLVERS
    assert tode._TABLEAUS == jode._TABLEAUS
    assert (tode._AB_COEFFS, tode._AM_COEFFS) == (jode._AB_COEFFS, jode._AM_COEFFS)


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("method", tode.FIXED_SOLVERS)
def test_fixed_solvers_match_jax(method, system):
    jf, tf = SYSTEMS[system]
    for steps in (3, 16):  # 16 steps saturate implicit_adams' order (11)
        want = np.asarray(jode.odeint(jf, jnp.asarray(Y0), jnp.linspace(0.0, 1.0, steps + 1), method=method))
        got = n(tode.odeint(tf, t(Y0), torch.linspace(0.0, 1.0, steps + 1), method=method))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fixed_solver_nonuniform_grid_and_bf16_state():
    jf, tf = SYSTEMS["nonlinear"]
    grid = np.asarray([0.0, 0.1, 0.15, 0.6, 1.0], np.float32)
    want = np.asarray(jode.odeint(jf, jnp.asarray(Y0), jnp.asarray(grid), method="rk4"))
    np.testing.assert_allclose(n(tode.odeint(tf, t(Y0), t(grid), method="rk4")), want, rtol=1e-5, atol=1e-5)
    got = tode.odeint(tf, t(Y0).to(torch.bfloat16), t(grid).to(torch.bfloat16), method="midpoint")
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("method", tode.ADAPTIVE_SOLVERS)
def test_adaptive_solvers_match_jax(method, system):
    jf, tf = SYSTEMS[system]
    kw = dict(rtol=1e-4, atol=1e-5) if method in ("fehlberg2", "adaptive_heun") else {}
    want = np.asarray(jode.odeint(jf, jnp.asarray(Y0), jnp.asarray([0.0, 1.0]), method=method, **kw))
    stats = {}
    got = n(tode.odeint(tf, t(Y0), t(np.asarray([0.0, 1.0], np.float32)), method=method, stats=stats, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert stats["accepted"] >= 1 and stats["f_evals"] > stats["accepted"]


@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
def test_adaptive_err_weight_first_step_and_max_steps_match_jax(method):
    """A padded state: the last column is padding with zero velocity, and
    err_weight / err_count keep it out of the error norm. The run cut by
    max_steps takes one step of a given size: a later step's size comes from
    an error estimate at f32 noise level, so where a longer cut run stops is
    not comparable between the packages (a run that reaches t1 is)."""
    jf0, tf0 = SYSTEMS["nonlinear"]
    w = np.asarray([1.0, 1.0, 0.0], np.float32)
    jf = lambda tt, y: jf0(tt, y) * jnp.asarray(w)
    tf = lambda tt, y: tf0(tt, y) * t(w)
    span = np.asarray([0.0, 1.0], np.float32)
    for kw in (dict(err_weight=w, err_count=4), dict(err_weight=w, err_count=4, first_step=0.05),
               dict(max_steps=1, first_step=0.05), dict(first_step=2.0)):
        jkw = {k: (jnp.asarray(v) if k == "err_weight" else v) for k, v in kw.items()}
        tkw = {k: (t(v) if k == "err_weight" else v) for k, v in kw.items()}
        want = np.asarray(jode.odeint(jf, jnp.asarray(Y0), jnp.asarray(span), method=method, **jkw))
        got = n(tode.odeint(tf, t(Y0), t(span), method=method, **tkw))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_adaptive_max_steps_ends_the_loop():
    stats = {}
    got = tode.odeint(lambda tt, y: -50.0 * y, t(Y0), torch.tensor([0.0, 100.0]), method="adaptive_heun",
                      max_steps=7, stats=stats)
    assert stats["accepted"] + stats["rejected"] == 7 and torch.isfinite(got).all()


@pytest.mark.parametrize("method", ["dopri5", "adaptive_heun"])
def test_adaptive_bf16_state_keeps_f32_controller(method):
    """dy/dt = y over [0, 1] with a bf16 state: the controller runs in f32, so
    dopri5 reaches e to bf16 precision, as in the JAX package. (The order-2
    solver sees bf16 noise in f as error, spends max_steps before t1 and
    returns where it got to; the two packages must still agree.)"""
    y0 = np.ones((2, 4), np.float32)
    want = np.asarray(jode.odeint(lambda tt, y: y, jnp.asarray(y0, jnp.bfloat16), jnp.asarray([0.0, 1.0]),
                                  method=method).astype(jnp.float32))
    got = tode.odeint(lambda tt, y: y, t(y0).to(torch.bfloat16), torch.tensor([0.0, 1.0]), method=method)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got.float()), want, rtol=1e-2)
    if method == "dopri5":
        np.testing.assert_allclose(n(got.float()), np.e, rtol=2e-2)


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="unknown solver"):
        tode.odeint(lambda tt, y: y, t(Y0), torch.linspace(0.0, 1.0, 3), method="rk45")


@pytest.fixture(scope="module")
def models():
    jmodel, params = jax_stabletts(seed=5)
    return jmodel, params, port_stabletts(params)


@pytest.mark.parametrize("solver,steps", [("rk4", 3), ("midpoint", 4), ("dopri5", 2)])
def test_synthesise_with_other_solvers_matches_jax(models, solver, steps):
    """max_mel_len 70 is padded to 256 inside: the adaptive error norm must
    cover the 70 requested frames only, in both packages."""
    jmodel, params, ours = models
    rng = np.random.default_rng(13)
    b, max_len = 2, 70
    x = rng.integers(1, 400, size=(b, 15))
    x_lengths = np.asarray([15, 9])
    x[1, 9:] = 0
    noise = rng.standard_normal((b, max_len, MEL_CFG.n_mels)).astype(np.float32)
    y_ref = rng.standard_normal((b, 25, MEL_CFG.n_mels)).astype(np.float32)
    kw = dict(n_timesteps=steps, cfg=2.0, max_mel_len=max_len, solver=solver)
    want = jsynthesise(jmodel, {"params": params}, jnp.asarray(x), jnp.asarray(x_lengths), jnp.asarray(noise),
                       jnp.asarray(y_ref), **kw)
    got = synthesise(ours, x, x_lengths, noise, y_ref, device="cpu", **kw)
    mel, jmel = n(got["decoder_outputs"]), np.asarray(want["decoder_outputs"])
    assert mel.shape == jmel.shape == (b, max_len, MEL_CFG.n_mels)
    assert float(np.abs(mel - jmel).max() / np.abs(jmel).max()) <= 1e-3
