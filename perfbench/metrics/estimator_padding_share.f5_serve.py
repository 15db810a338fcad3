"""Padding share of F5-TTS's estimator as the program counts it (sampler,
models/sampler.py): 1 - the items' total frames, prompt included
(`sampler.frames_valid`), over the rows times the frames the estimator ran
(`sampler.frames_computed`)."""

from perfbench.lib.spans import program_snapshot


def read(ctx):
    snap = program_snapshot()
    if snap is None:
        return None
    c = snap["counters"]
    computed = c.get("sampler.frames_computed", 0)
    return 100.0 * (1.0 - c.get("sampler.frames_valid", 0) / computed) if computed else None
