"""Padding share of the vocoder as the program counts it (model step,
models/ffgan.py): 1 - the items' frames (`vocoder.frames_valid`) over the
items times the frames the vocoder ran (`vocoder.frames_computed`)."""

from perfbench.lib.spans import program_snapshot


def read(ctx):
    snap = program_snapshot()
    if snap is None:
        return None
    c = snap["counters"]
    computed = c.get("vocoder.frames_computed", 0)
    return 100.0 * (1.0 - c.get("vocoder.frames_valid", 0) / computed) if computed else None
