"""Arithmetic that several per-layer readers share. A reader gets `ctx`:
`trace` (lib/trace.summarize), `work` (the driver's count of the window's
work), `window_s` and `cell`; it returns a number, or None when it finds
nothing to read."""

from __future__ import annotations

from perfbench.counts.peaks import PEAK_FLOPS


def idle_share(ctx) -> float:
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx) -> float:
    w = ctx["work"]
    if not w.get("flops"):
        return None
    return 100.0 * w["flops"] / (ctx["window_s"] * PEAK_FLOPS[w["dtype"]])


def roofline(ctx, layer: str) -> float:
    """Least time of the layer's work over the device time of its range."""
    device_s = ctx["trace"]["ranges_s"].get(layer, 0.0)
    least = ctx["work"].get("least_s", {}).get(layer, 0.0)
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s


def padding_share(ctx) -> float:
    w = ctx["work"]
    if not w.get("estimator_frames"):
        return None
    return 100.0 * (1.0 - w["valid_frames"] / w["estimator_frames"])
