"""Device time of a callable's kernels from torch.profiler, for the A/B
tools and probes that time calls shorter than the host takes to issue them
(their CUDA-event times carry the host's issue time). Nothing of the port
calls it.
"""

from __future__ import annotations


def device_ms(fn, calls: int = 20) -> tuple:
    """(device ms per call of fn, {kernel: device ms per call}) over `calls`
    calls after one warm-up call; a kernel is named by the first 120
    characters of its name, which hold its template arguments."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by[e.key[:120]] = by.get(e.key[:120], 0.0) + e.self_device_time_total / calls / 1e3
    return sum(by.values()), by
