"""The traced run's readings: `record_function` ranges opened by forward
hooks on named modules of the program, and a torch.profiler trace of the
window reduced to device busy time, device time by range and by kernel, the
device operations counted, and the idle gaps named by what the host was
doing meanwhile.

Hooks and profiler exist only in a `--trace 1` run; the end-to-end metrics
come from `--trace 0` runs, which have neither.
"""

from __future__ import annotations

import re

import numpy as np
import torch

RANGE_PREFIX = "perfbench."


class ModuleRanges:
    """Opens a `record_function` range named `perfbench.<range>` around each
    forward of the modules that a pattern names: a dotted module name of the
    acoustic model, `*` standing for one part (`decoder.estimator.blocks.*.block`),
    or `<root>` followed by such a name for another root (`<vocoder>` is the
    whole vocoder). Removed by `close`."""

    def __init__(self, roots: dict, patterns: dict):
        self._handles = []
        for range_name, pats in patterns.items():
            for pat in pats:
                root, name_pat = ("acoustic", pat) if not pat.startswith("<") else pat[1:].split(">", 1)
                regex = re.compile(re.escape(name_pat.lstrip(".")).replace(r"\*", r"[^.]+") + r"\Z")
                for name, mod in roots[root].named_modules():
                    if regex.match(name):
                        self._hook(mod, RANGE_PREFIX + range_name)

    def _hook(self, mod, label: str):
        stack = []

        def pre(_m, _args):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out):
            stack.pop().__exit__(None, None, None)

        self._handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

    def close(self):
        for h in self._handles:
            h.remove()
        self._handles = []


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end] rows."""
    if len(intervals) == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def range_seconds(dev: list, marks: dict) -> dict:
    """Device seconds of the operations that run inside each range's spans
    on the device timeline. The spans are the profiler's device-side marks
    of the `record_function` ranges: from the first to the last operation
    launched inside the range, on the one stream, so every operation
    within a span is the range's own."""
    if not dev:
        return {}
    starts = np.array([d[0] for d in dev], dtype=np.float64)
    ends = np.array([d[1] for d in dev], dtype=np.float64)
    order = np.argsort(starts)
    starts, ends = starts[order], ends[order]
    csum = np.concatenate([[0.0], np.cumsum(ends - starts)])
    out = {}
    for name, spans in marks.items():
        total = 0.0
        for s, e in _merge(np.array(spans, dtype=np.float64).reshape(-1, 2)):
            lo, hi = np.searchsorted(starts, s, "left"), np.searchsorted(starts, e, "right")
            total += csum[hi] - csum[lo]
        out[name] = float(total) * 1e-6
    return out


def summarize(prof, window_s: float, n_gaps: int = 10) -> dict:
    """Reduces a finished profile. Times in seconds.

    busy_s        union of the device operations' intervals
    device_ops    device seconds by operation name, largest first
    ranges_s      device seconds of the operations inside each
                  `perfbench.<range>` (RANGE_PREFIX stripped; `range_seconds`)
    ops           device operations counted (kernels, copies, sets)
    idle_gaps     idle device time inside the window, summed by the name of
                  the innermost host operation running at the gap's start,
                  largest first
    """
    from torch.autograd import DeviceType

    events = prof.events()
    dev, host, marks = [], [], {}
    for e in events:
        tr = e.time_range
        on_device = e.device_type == DeviceType.CUDA
        if on_device and (getattr(e, "is_user_annotation", False) or e.name.startswith(RANGE_PREFIX)):
            # a range's span on the device timeline (the harness's or the program's own), no operation
            if e.name.startswith(RANGE_PREFIX):
                marks.setdefault(e.name[len(RANGE_PREFIX):], []).append((tr.start, tr.end))
            continue
        if e.name.startswith(RANGE_PREFIX) or e.name.startswith("ProfilerStep"):
            continue
        (dev if on_device else host).append((tr.start, tr.end, e.name))
    by_op: dict = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    dev_iv = _merge(np.array([(s, e) for s, e, _ in dev], dtype=np.float64).reshape(-1, 2))
    ranges = range_seconds(dev, marks)
    busy_s = float((dev_iv[:, 1] - dev_iv[:, 0]).sum()) * 1e-6 if len(dev_iv) else 0.0

    gaps = []
    if len(dev_iv) and host:
        h_start = np.array([h[0] for h in host], dtype=np.float64)
        h_end = np.array([h[1] for h in host], dtype=np.float64)
        win_start = min(h_start.min(), dev_iv[0, 0])
        edges = np.concatenate([[win_start], dev_iv[:, 1]])
        nexts = np.concatenate([dev_iv[:, 0], [max(h_end.max(), dev_iv[-1, 1])]])
        lens = nexts - edges
        order = np.argsort(-lens)[: 64 * n_gaps]
        named: dict = {}
        for i in order:
            if lens[i] <= 0:
                break
            at = edges[i]
            live = np.nonzero((h_start <= at) & (h_end > at))[0]
            name = host[live[np.argmax(h_start[live])]][2] if len(live) else "(no host op)"
            named[name] = named.get(name, 0.0) + lens[i] * 1e-6
        gaps = sorted(named.items(), key=lambda kv: -kv[1])[:n_gaps]
    return {"busy_s": busy_s, "window_s": window_s, "ops": len(dev), "ranges_s": ranges,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1]),
            "idle_gaps": [[n, s] for n, s in gaps]}


def breakdown(summary: dict, n: int = 10) -> dict:
    return {"device_ops": [[name, s] for name, s in summary["device_ops"][:n]],
            "idle_gaps": summary["idle_gaps"][:n]}
