"""Fixed-grid ODE integration for the flow-matching sampler (Euler; the step
sizes are the grid's differences, as torchdiffeq's fixed-grid solvers)."""

from __future__ import annotations

from typing import Callable

import torch

FIXED_SOLVERS = ("euler",)


def odeint(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], y0: torch.Tensor,
           t_span: torch.Tensor, method: str = "euler") -> torch.Tensor:
    """Integrate dy/dt = f(t, y) over the grid t_span ([N+1]); returns the
    final state in y0's dtype."""
    if method not in FIXED_SOLVERS:
        raise NotImplementedError(f"solver {method!r} is not available; supported: {FIXED_SOLVERS}")
    y = y0
    for i in range(t_span.shape[0] - 1):
        t, dt = t_span[i], t_span[i + 1] - t_span[i]
        y = (y + dt * f(t, y)).to(y0.dtype)
    return y
