"""ODE passes per request (API, api.py): the program's count of `sampler.ode`
spans (one per `odeint`, so one per pass of the API's regrow loop) over its
`api.requests` counter."""

from perfbench.lib.spans import program_snapshot


def read(ctx):
    snap = program_snapshot()
    if snap is None:
        return None
    n = snap["counters"].get("api.requests", 0)
    return snap["spans"].get("sampler.ode", {}).get("calls", 0) / n if n else None
