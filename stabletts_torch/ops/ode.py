"""ODE solvers for the flow-matching sampler, the counterpart of the JAX
package's `ops/ode.py`: fixed-grid integrators that evaluate exactly on the
grid, as torchdiffeq's fixed-grid solvers do (Euler, midpoint, Heun 2 and 3,
RK4, the implicit Adams-Bashforth-Moulton), and torchdiffeq's adaptive
embedded Runge-Kutta solvers (dopri5, bosh3, fehlberg2, adaptive_heun). All
integrate dy/dt = f(t, y) with t a 0-dim tensor.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, Optional

import torch

from stabletts_torch.utils.metrics import span

FIXED_SOLVERS = ("euler", "midpoint", "heun2", "heun3", "rk4", "implicit_adams")
ADAPTIVE_SOLVERS = ("dopri5", "bosh3", "fehlberg2", "adaptive_heun")

Field = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _euler(f, y, t, dt):
    return y + dt * f(t, y)


def _midpoint(f, y, t, dt):
    k1 = f(t, y)
    return y + dt * f(t + dt * 0.5, y + dt * 0.5 * k1)


def _heun2(f, y, t, dt):
    k1 = f(t, y)
    k2 = f(t + dt, y + dt * k1)
    return y + dt * 0.5 * (k1 + k2)


def _heun3(f, y, t, dt):
    k1 = f(t, y)
    k2 = f(t + dt / 3, y + dt / 3 * k1)
    k3 = f(t + dt * 2 / 3, y + dt * 2 / 3 * k2)
    return y + dt * 0.25 * (k1 + 3 * k3)


def _rk4(f, y, t, dt):
    k1 = f(t, y)
    k2 = f(t + dt * 0.5, y + dt * 0.5 * k1)
    k3 = f(t + dt * 0.5, y + dt * 0.5 * k2)
    k4 = f(t + dt, y + dt * k3)
    return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


_STEPPERS = {"euler": _euler, "midpoint": _midpoint, "heun2": _heun2, "heun3": _heun3, "rk4": _rk4}


def odeint_fixed(f: Field, y0: torch.Tensor, t_span: torch.Tensor, method: str = "euler") -> torch.Tensor:
    """Integrate over the grid t_span ([N+1]) and return the final state in
    y0's dtype. The step sizes are the grid's differences."""
    if method == "implicit_adams":
        return _odeint_implicit_adams(f, y0, t_span)
    stepper = _STEPPERS[method]
    y = y0
    for i in range(t_span.shape[0] - 1):
        with span("ode.step"):
            t, dt = t_span[i], t_span[i + 1] - t_span[i]
            y = stepper(f, y, t, dt).to(y0.dtype)
    return y


def _adams_coefficients(max_order: int = 12):
    """Exact Adams-Bashforth / Adams-Moulton coefficients by rational
    integration of the Lagrange basis (torchdiffeq's fixed_adams.py tables,
    derived instead of transcribed). ab[k][j] multiplies f_{n-j} (k terms);
    am[k][0] multiplies f_{n+1} and am[k][j >= 1] multiplies f_{n-(j-1)}."""

    def lagrange_integrals(nodes):
        coeffs = []
        for j, xj in enumerate(nodes):
            poly = [Fraction(1)]  # ascending coefficients of prod(s - x_i)
            denom = Fraction(1)
            for i, xi in enumerate(nodes):
                if i == j:
                    continue
                new = [Fraction(0)] * (len(poly) + 1)
                for k, c in enumerate(poly):
                    new[k + 1] += c
                    new[k] -= c * xi
                poly = new
                denom *= xj - xi
            integral = sum(c / (k + 1) for k, c in enumerate(poly))
            coeffs.append(float(integral / denom))
        return coeffs

    ab = {k: lagrange_integrals([Fraction(-i) for i in range(k)]) for k in range(1, max_order)}
    am = {k: lagrange_integrals([Fraction(1 - i) for i in range(k)]) for k in range(1, max_order + 1)}
    return ab, am


_AB_COEFFS, _AM_COEFFS = _adams_coefficients()
# torchdiffeq fixed_adams.py: orders below _ADAMS_MIN_ORDER - 1 bootstrap with
# the 3/8-rule RK4; the history holds _ADAMS_MAX_ORDER - 1 values; the
# Adams-Moulton corrector runs at most _ADAMS_MAX_ITERS iterations
_ADAMS_MIN_ORDER = 4
_ADAMS_MAX_ORDER = 12
_ADAMS_MAX_ITERS = 4


def _odeint_implicit_adams(f: Field, y0, t_span, rtol: float = 1e-7, atol: float = 1e-9):
    """torchdiffeq's `implicit_adams` on the grid: the first two steps use the
    3/8-rule RK4, then the order grows with the history of f values up to 11;
    each step is an Adams-Bashforth predictor and an Adams-Moulton corrector
    iterated at most 4 times, stopping when torchdiffeq's element-wise
    convergence ratio falls below 1 (read from the device each iteration). The
    state and the history are f32; only f sees y0's dtype."""
    y_dtype = y0.dtype
    ts = t_span.float()
    hist_cap = _ADAMS_MAX_ORDER - 1

    def f32_eval(t, y):
        return f(t, y.to(y_dtype)).float()

    y = y0.float()
    hist: list = []  # f at past grid points, newest first
    for i in range(ts.shape[0] - 1):
        with span("ode.step"):
            t0, t1 = ts[i], ts[i + 1]
            dt = t1 - t0
            f0 = f32_eval(t0, y)
            hist = [f0] + hist[: hist_cap - 1]
            order = len(hist)
            if order < _ADAMS_MIN_ORDER - 1:
                k1 = f0
                k2 = f32_eval(t0 + dt / 3, y + dt * k1 / 3)
                k3 = f32_eval(t0 + dt * 2 / 3, y + dt * (k2 - k1 / 3))
                k4 = f32_eval(t1, y + dt * (k1 - k2 + k3))
                dy = (k1 + 3 * (k2 + k3) + k4) * dt * 0.125
            else:
                ab, am = _AB_COEFFS[order], _AM_COEFFS[order + 1]
                dy = dt * sum(ab[j] * hist[j] for j in range(order))
                delta = dt * sum(am[j + 1] * hist[j] for j in range(order))
                for _ in range(_ADAMS_MAX_ITERS):
                    dy_new = dt * am[0] * f32_eval(t1, y + dy) + delta
                    scale = atol + rtol * torch.maximum(dy.abs(), dy_new.abs())
                    converged = bool(((dy - dy_new).abs() / scale).max() < 1.0)
                    dy = dy_new
                    if converged:
                        break
            y = y + dy
    return y.to(y_dtype)


# Embedded Runge-Kutta tableaus in torchdiffeq's representation:
# (alpha [s-1], beta rows, c_sol [s], c_error [s], order, c_mid [s]).
# c_error is b_high - b_low; dopri5's 4th-order weights are torchdiffeq's
# (1951/21600, ...), not the textbook set. c_mid gives y(t0 + dt/2) for the
# quartic dense-output interpolant (dopri5: DPS_C_MID; bosh3: _BS_C_MID; the
# two order-2 solvers use c_sol / 2).
_DOPRI5_B_LOW = [1951 / 21600, 0.0, 22642 / 50085, 451 / 720, -12231 / 42400, 649 / 6300, 1 / 60]
_DOPRI5_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_TABLEAUS = {
    "dopri5": (
        [1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
        [
            [1 / 5],
            [3 / 40, 9 / 40],
            [44 / 45, -56 / 15, 32 / 9],
            [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
            [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
            [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
        ],
        _DOPRI5_B,
        [h - l for h, l in zip(_DOPRI5_B, _DOPRI5_B_LOW)],
        5,
        [
            6025192743 / 30085553152 / 2, 0.0, 51252292925 / 65400821598 / 2,
            -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
            -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2,
        ],
    ),
    "bosh3": (
        [1 / 2, 3 / 4, 1.0],
        [[1 / 2], [0.0, 3 / 4], [2 / 9, 1 / 3, 4 / 9]],
        [2 / 9, 1 / 3, 4 / 9, 0.0],
        [2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8],
        3,
        [0.0, 0.5, 0.0, 0.0],
    ),
    "fehlberg2": (
        [1 / 2, 1.0],
        [[1 / 2], [1 / 256, 255 / 256]],
        [1 / 512, 255 / 256, 1 / 512],
        [1 / 512 - 1 / 256, 0.0, 1 / 512],
        2,
        [1 / 1024, 255 / 512, 1 / 1024],
    ),
    "adaptive_heun": (
        [1.0],
        [[1.0]],
        [1 / 2, 1 / 2],
        [-1 / 2, 1 / 2],
        2,
        [1 / 4, 1 / 4],
    ),
}


def odeint_adaptive(f: Field, y0: torch.Tensor, t0, t1, method: str = "dopri5", rtol: float = 1e-5,
                    atol: float = 1e-5, max_steps: int = 256, first_step: Optional[float] = None,
                    err_weight: Optional[torch.Tensor] = None, err_count: Optional[int] = None,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """Adaptive embedded-RK integration from t0 to t1 with torchdiffeq's
    algorithm, ending after at most `max_steps` attempts (accepted or
    rejected), as the JAX package's `odeint_adaptive`:

    * first_step=None selects the initial step as torchdiffeq's
      `_select_initial_step` (two more f evaluations at t0).
    * steps are not clamped at t1: the solver overshoots, and the result at
      t1 is read from the quartic dense-output interpolant of the last
      accepted step.
    * controller: factor = min(10, max(0.9 / e^(1/order), dfactor)), dfactor 1
      on an accepted step and 0.2 on a rejected one, e the RMS of error /
      (atol + rtol * max(|y0|, |y1|)).
    * FSAL: the next step's first stage is the last stage of the accepted one.

    The loop runs on the host: every attempt reads its accept decision (and
    the time reached) from the device, one synchronisation per attempt.

    The controller (t, dt, the error norm) and the stage sums are f32 whatever
    y0's dtype, because bf16 time quantises the steps; only f sees y0's dtype.
    err_weight (broadcastable to y, 1 at valid elements) and err_count (their
    number) restrict the error norm to the valid region of a padded state.
    If `stats` is a dict it receives `accepted`, `rejected` and `f_evals`.
    """
    alpha, beta, c_sol, c_err, order, c_mid = _TABLEAUS[method]
    n_stages = len(c_sol)
    y_dtype = y0.dtype
    dev = y0.device
    is_fsal = c_sol[-1] == 0.0 and list(beta[-1]) == list(c_sol[:-1])
    f_evals = [0]

    def f32_eval(t, y):
        f_evals[0] += 1
        return f(t, y.to(y_dtype)).float()

    if err_weight is None:
        def rms(x):
            return x.square().mean().sqrt()
    else:
        w = err_weight.to(dev, torch.float32)
        cnt = float(err_count if err_count is not None else y0.numel())

        def rms(x):
            return ((x * w).square().sum() / cnt).sqrt()

    def rk_step(t, dt, y, f0):
        ks = [f0]
        for i in range(n_stages - 1):
            yi = y
            for j, b in enumerate(beta[i]):
                if b != 0.0:
                    yi = yi + dt * b * ks[j]
            ks.append(f32_eval(t + dt * alpha[i], yi))
        if is_fsal:
            y1 = yi  # the last stage's input is y1 (its beta row is c_sol)
        else:
            y1 = y
            for i in range(n_stages):
                if c_sol[i] != 0.0:
                    y1 = y1 + dt * c_sol[i] * ks[i]
        err = torch.zeros_like(y)
        y_mid = y
        for i in range(n_stages):
            if c_err[i] != 0.0:
                err = err + dt * c_err[i] * ks[i]
            if c_mid[i] != 0.0:
                y_mid = y_mid + dt * c_mid[i] * ks[i]
        return y1, ks[-1], err, y_mid

    def interp_fit(ya, yb, y_mid, fa, fb, dt):
        # torchdiffeq _interp_fit: the quartic through (ya, y_mid, yb) with end
        # slopes dt*fa and dt*fb, in x = (t - t0) / dt
        a = 2.0 * dt * (fb - fa) - 8.0 * (yb + ya) + 16.0 * y_mid
        b = dt * (5.0 * fa - 3.0 * fb) + 18.0 * ya + 14.0 * yb - 32.0 * y_mid
        c = dt * (fb - 4.0 * fa) - 11.0 * ya - 5.0 * yb + 16.0 * y_mid
        return a, b, c, dt * fa, ya

    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    y = y0.float()
    t0, t1 = f32(t0), f32(t1)
    fc = f32_eval(t0, y)

    if first_step is None:
        iscale = atol + y.abs() * rtol
        d0, d1 = rms(y / iscale), rms(fc / iscale)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), f32(1e-6), 0.01 * d0 / d1)
        fp = f32_eval(t0 + h0, y + h0 * fc)
        d2 = rms((fp - fc) / iscale) / h0
        h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), torch.maximum(f32(1e-6), h0 * 1e-3),
                         (0.01 / torch.maximum(d1, d2)) ** (1.0 / order))
        dt = torch.minimum(100.0 * h0, h1)
    else:
        dt = f32(first_step)

    t_prev, t_cur = t0, t0
    t_cur_host, t1_host = float(t0), float(t1)
    coeffs = None
    accepted = rejected = 0
    while t_cur_host < t1_host and accepted + rejected < max_steps:
        with span("ode.step"):
            y_new, f_new, err, y_mid = rk_step(t_cur, dt, y, fc)
            e = rms(err / (atol + rtol * torch.maximum(y.abs(), y_new.abs())))
            t_next = t_cur + dt
            e_host, t_next_host = torch.stack([e, t_next]).tolist()
            # never shrink on an accepted step (dfactor 1); e = 0 gives the largest growth
            dfac = torch.where(e < 1.0, f32(1.0), f32(0.2))
            efac = 0.9 * torch.clamp_min(e, 1e-10) ** (-1.0 / order)
            fac = torch.minimum(f32(10.0), torch.maximum(efac, dfac))
            if e_host <= 1.0:
                coeffs = interp_fit(y, y_new, y_mid, fc, f_new, dt)
                t_prev, t_cur, t_cur_host = t_cur, t_next, t_next_host
                y, fc = y_new, f_new
                accepted += 1
            else:
                rejected += 1
            dt = dt * fac
    if stats is not None:
        stats.update(accepted=accepted, rejected=rejected, f_evals=f_evals[0])

    if coeffs is None:  # no accepted step: the state is still y0
        return y.to(y_dtype)
    # dense output at t1 (torchdiffeq _interp_evaluate); a last step that
    # landed on t1 gives x = 1 and the accepted state
    x = torch.clamp((t1 - t_prev) / torch.clamp_min(t_cur - t_prev, 1e-30), 0.0, 1.0)
    a, b, c, d, e_ = coeffs
    return ((((a * x + b) * x + c) * x + d) * x + e_).to(y_dtype)


def odeint(f: Field, y0: torch.Tensor, t_span: torch.Tensor, method: str = "euler", **kwargs) -> torch.Tensor:
    """Fixed-grid solvers integrate over the grid t_span; adaptive solvers
    from t_span[0] to t_span[-1] with step control (and take `rtol`, `atol`,
    `max_steps`, `first_step`, `err_weight`, `err_count`)."""
    if method in FIXED_SOLVERS:
        return odeint_fixed(f, y0, t_span, method)
    if method in ADAPTIVE_SOLVERS:
        return odeint_adaptive(f, y0, t_span[0], t_span[-1], method=method, **kwargs)
    raise ValueError(f"unknown solver {method!r}; supported: {FIXED_SOLVERS + ADAPTIVE_SOLVERS}")
