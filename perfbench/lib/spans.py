"""The program's own spans and counters (`stabletts_torch.utils.metrics`),
which it keeps while a profiler records: in a traced run, those of the
window alone. A reader of them returns None where the program keeps none."""

from __future__ import annotations


def program_snapshot():
    """{"spans": {name: {"calls", "total_ns", "self_ns"}}, "counters": {...}},
    or None where the program has no such store."""
    try:
        from stabletts_torch.utils.metrics import snapshot
    except ImportError:
        return None
    return snapshot()


def host_ms_per(names, counter: str):
    """Host ms of the spans `names` together over the program's `counter`."""
    snap = program_snapshot()
    if snap is None:
        return None
    n = snap["counters"].get(counter, 0)
    if not n:
        return None
    return sum(snap["spans"].get(k, {}).get("total_ns", 0) for k in names) / n / 1e6
