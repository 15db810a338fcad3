"""The port's learning-rate schedules (stabletts_torch/train/scheduler.py)
against the JAX package's (stabletts_tpu/train/scheduler.py) at every step
from 0 to total + 10: the port's multiplier times lr against the JAX
function, warmup 0 included.

JAX evaluates a schedule in f32 unless x64 is on, and the f32 rounding of
cos near the end of a cosine decay is over 1e-6 of the (tiny) value there;
so the formulas are compared in x64 at rtol 1e-6, and the JAX package's own
f32 values within two f32 ulps of lr."""

import jax
import numpy as np
import pytest

from stabletts_torch.train import scheduler as P
from stabletts_tpu.train import scheduler as J

LR = 3e-4
RUNS = [(0, 50), (10, 50), (200, 1000)]  # (warmup, total)


def _pairs(warmup: int, total: int) -> dict:
    """name -> (JAX schedule, the port's multiplier)."""
    return {
        "cosine": (J.cosine_with_warmup(LR, warmup, total), P.cosine_with_warmup(warmup, total)),
        "constant": (J.constant_with_warmup(LR, warmup), P.constant_with_warmup(warmup)),
        "linear": (J.linear_with_warmup(LR, warmup, total), P.linear_with_warmup(warmup, total)),
        "inverse_sqrt": (J.inverse_sqrt_with_warmup(LR, warmup), P.inverse_sqrt_with_warmup(warmup)),
        "cosine_restarts": (J.cosine_with_restarts_warmup(LR, warmup, total), P.cosine_with_restarts_warmup(warmup, total)),
        "cosine_restarts_2": (J.cosine_with_restarts_warmup(LR, warmup, total, num_cycles=2),
                              P.cosine_with_restarts_warmup(warmup, total, num_cycles=2)),
        "polynomial": (J.polynomial_with_warmup(LR, warmup, total), P.polynomial_with_warmup(LR, warmup, total)),
        "polynomial_power_2": (J.polynomial_with_warmup(LR, warmup, total, lr_end=1e-6, power=2.0),
                               P.polynomial_with_warmup(LR, warmup, total, lr_end=1e-6, power=2.0)),
        "wsd": (J.warmup_stable_decay(LR, warmup, total), P.warmup_stable_decay(warmup, total)),
        "wsd_0.3": (J.warmup_stable_decay(LR, warmup, total, decay_fraction=0.3),
                    P.warmup_stable_decay(warmup, total, decay_fraction=0.3)),
    }


NAMES = list(_pairs(0, 1))


def _values(name, warmup, total, x64: bool):
    jfn, pfn = _pairs(warmup, total)[name]
    steps = range(total + 11)
    with jax.enable_x64(x64):
        want = np.array([float(jfn(s)) for s in steps])
    got = np.array([pfn(s) * LR for s in steps])
    return got, want


@pytest.mark.parametrize("warmup,total", RUNS)
@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_jax_formula(name, warmup, total):
    got, want = _values(name, warmup, total, x64=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("warmup,total", RUNS)
@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_jax_f32_values(name, warmup, total):
    got, want = _values(name, warmup, total, x64=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0 ** -23 * LR)


def test_edge_cases():
    assert P.constant_with_warmup(0)(0) == 0.0 and P.constant_with_warmup(0)(1) == 1.0  # min(step / 1, 1)
    # no warmup: the timescale falls back to 10000, so the rate holds there and then decays
    isq = P.inverse_sqrt_with_warmup(0)
    assert isq(0) == isq(10_000) == 1.0 and isq(40_000) == 0.5
    poly = P.polynomial_with_warmup(LR, 10, 50, lr_end=1e-6)
    assert poly(51) * LR == pytest.approx(1e-6, rel=1e-12) and poly(50) * LR == pytest.approx(1e-6, rel=1e-12)
    assert P.cosine_with_restarts_warmup(0, 50)(50) == 0.0
