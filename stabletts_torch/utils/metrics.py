"""Training metrics and tracing.

The reference logs scalars to TensorBoard on rank 0 (reference: train.py:84-89,
vocoders/vocos/train.py:134-148) and has no profiling at all (SURVEY §5.1).
Here: a TensorBoard writer when the package is importable, with a JSONL
fallback (`MetricWriter`, a copy of the JAX package's), torch.profiler trace
hooks (`profile_trace`: a Chrome trace of the host and the GPU), and the
program's own spans and counters.

Spans and counters are on exactly while a torch profiler records
(`torch.autograd._profiler_enabled()`). Otherwise `span(name)` returns one
shared no-op context and `count(...)` returns at once: one check a call,
nothing allocated, no `record_function`. While a profiler records,
`span(name)` opens `record_function("stts." + name)`, so the span stands in
the trace on the device's clock, and keeps the span in memory: name, start
and end (`time.perf_counter_ns`), the index of its parent span, and the unit
(a request or a training step) it belongs to. A span opened with
`new_unit=True` starts a unit; the spans inside it inherit it. The store
holds at most `CAPACITY` spans and pending device values; what comes past
that is counted as dropped. Nothing here synchronizes the device: a counter
given a tensor keeps a reference to it and sums it in `snapshot()`.

torch's profiler is thread-local: it records, and `_profiler_enabled()` is
true, only on the thread that started it. So spans and counters are kept for
that thread alone, and work on any other thread (a request handled by the
web UI's `ThreadingHTTPServer`, the data loader's workers) is neither traced
nor counted. Trace a server by calling the API on the profiler's thread.

Spans the program opens (and the counters beside them):

  api.request (new unit; api.requests), api.g2p, api.ref_mel,
  api.synthesise (the regrow loop, one a request), api.vocode,
  api.to_host                                                   api.py
  sampler.prepare (text_encoder, duration_predictor inside it), sampler.ode
  (sampler.frames_valid, sampler.frames_computed)      models/sampler.py
  ode.step (one a solver step or attempt)                       ops/ode.py
  vocoder, vocoder.istft_head                              models/vocos.py
  vocoder, ffgan.backbone, ffgan.head (vocoder.frames_valid,
  vocoder.frames_computed)                                 models/ffgan.py
  train.step (new unit; train.steps), train.forward, train.backward,
  train.update                                        train/train_tts.py
  data.wait (the consumer's wait for the next item)       data/prefetch.py

Counters without a span: tap_gemm.tma, tap_gemm.producer_copy and
tap_gemm.fallback, one a bf16 tap GEMM launch by the path that its kernel
feeds its ring by (ops/tap_gemm_cuda.py; counted by the wrappers of
dit_block, convnext_block, dit_attention, adaln_ffn and tap_gemm).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
from torch.autograd import _profiler_enabled

PREFIX = "stts."
CAPACITY = 1 << 16


class MetricWriter:
    """Scalar writer: TensorBoard if available, always JSONL."""

    def __init__(self, log_dir: str, jsonl_name: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, jsonl_name), "a", encoding="utf-8")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self._jsonl.write(json.dumps({"step": step, tag: value}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, metrics: dict, step: int, prefix: str = "") -> None:
        rec = {"step": step}
        for k, v in metrics.items():
            rec[prefix + k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(prefix + k, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler over the block (CPU activities, and CUDA ones where a
    GPU is present); on exit writes a Chrome trace `trace_<pid>_<ms>.json`
    into `log_dir`, and beside it `spans_<pid>_<ms>.jsonl`: the block's spans,
    one JSON object a line (name, start_ns, end_ns, parent: the line index of
    the parent span or -1, unit: the request or step id), which groups the
    spans by request. Yields the profiler (for `key_averages()`), or None and
    profiles nothing when log_dir is None. The program's spans and counters
    are reset on entry, so `snapshot()` after the block holds the block's.
    Only the thread that enters the block is traced (module docstring)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    reset()
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    stem = f"{os.getpid()}_{int(time.time() * 1e3)}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
    with open(os.path.join(log_dir, f"spans_{stem}.jsonl"), "w", encoding="utf-8") as f:
        for name, start, end, parent, unit in TRACER.records():
            f.write(json.dumps({"name": name, "start_ns": start, "end_ns": end, "parent": parent, "unit": unit}) + "\n")


class Tracer:
    """The in-memory store of spans and counters (module docstring). Spans
    record only on the profiler's own thread, so one stack nests them."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.reset()

    def reset(self) -> None:
        """Forgets every span, counter and pending value."""
        self._spans: list = []  # [name, start_ns, end_ns or None, parent index or -1, unit or None]
        self._stack: list = []  # (index or -1 past the cap, record) of each open span
        self._counts: dict = {}
        self._pending: list = []  # (counter, tensor) summed in snapshot()
        self._units = 0
        self.dropped = 0

    def open(self, name: str, new_unit: bool = False) -> tuple:
        """Starts a span now; returns the handle `close` takes."""
        top = self._stack[-1] if self._stack else None
        if new_unit:
            unit = self._units
            self._units += 1
        else:
            unit = top[1][4] if top is not None else None
        rec = [name, time.perf_counter_ns(), None, top[0] if top is not None else -1, unit]
        index = -1
        if len(self._spans) + len(self._pending) < self.capacity:
            index = len(self._spans)
            self._spans.append(rec)
        else:
            self.dropped += 1
        entry = (index, rec)
        self._stack.append(entry)
        return entry

    def close(self, entry: tuple) -> None:
        entry[1][2] = time.perf_counter_ns()
        if self._stack and self._stack[-1] is entry:
            self._stack.pop()

    def count(self, name: str, n=1) -> None:
        """Adds n (an int, or a tensor summed in `snapshot()`) to a counter."""
        if not isinstance(n, torch.Tensor):
            self._counts[name] = self._counts.get(name, 0) + n
        elif len(self._spans) + len(self._pending) < self.capacity:
            self._pending.append((name, n))
        else:
            self.dropped += 1

    def records(self) -> list:
        """Every span as a (name, start_ns, end_ns, parent, unit) tuple, in the
        order they opened; `parent` indexes this list (-1: none), end_ns is
        None while the span is open."""
        return [tuple(r) for r in self._spans]

    def snapshot(self) -> dict:
        """{"spans": {name: {"calls", "total_ns", "self_ns"}}, "counters":
        {name: value}, "dropped": n}. A span's self time is its duration less
        its finished child spans'. Counters given tensors are summed here."""
        spans = self._spans
        child_ns = [0] * len(spans)
        for _, start, end, parent, _ in spans:
            if end is not None and parent >= 0:
                child_ns[parent] += end - start
        by_name: dict = {}
        for i, (name, start, end, _, _) in enumerate(spans):
            if end is None:
                continue
            s = by_name.setdefault(name, {"calls": 0, "total_ns": 0, "self_ns": 0})
            s["calls"] += 1
            s["total_ns"] += end - start
            s["self_ns"] += end - start - child_ns[i]
        counts = dict(self._counts)
        for name, t in self._pending:
            counts[name] = counts.get(name, 0) + int(t.sum())
        return {"spans": by_name, "counters": counts, "dropped": self.dropped}


class _Span:
    __slots__ = ("_name", "_new_unit", "_rf", "_entry")

    def __init__(self, name: str, new_unit: bool):
        self._name, self._new_unit = name, new_unit

    def __enter__(self):
        self._rf = torch.profiler.record_function(PREFIX + self._name)
        self._rf.__enter__()
        self._entry = TRACER.open(self._name, self._new_unit)
        return self

    def __exit__(self, *exc):
        TRACER.close(self._entry)
        self._rf.__exit__(*exc)
        return False


TRACER = Tracer()
_OFF = contextlib.nullcontext()


def span(name: str, new_unit: bool = False):
    """A context over one piece of work named `name` (module docstring); the
    shared no-op context while no profiler records."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, new_unit)


def count(name: str, n=1) -> None:
    """Adds n to counter `name` while a profiler records; else does nothing."""
    if _profiler_enabled():
        TRACER.count(name, n)


def snapshot() -> dict:
    return TRACER.snapshot()


def records() -> list:
    return TRACER.records()


def reset() -> None:
    TRACER.reset()
