"""Host milliseconds per ODE step (sampler, ops/ode.py): the program's
`ode.step` spans, each one solver step's launches, over their count."""

from perfbench.lib.spans import program_snapshot


def read(ctx):
    snap = program_snapshot()
    if snap is None:
        return None
    step = snap["spans"].get("ode.step", {})
    return step["total_ns"] / step["calls"] / 1e6 if step.get("calls") else None
