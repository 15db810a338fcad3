"""Training metrics and profiling.

The reference logs scalars to TensorBoard on rank 0 (reference: train.py:84-89,
vocoders/vocos/train.py:134-148) and has no profiling at all (SURVEY §5.1).
Here: a TensorBoard writer when the package is importable, with a JSONL
fallback, plus torch.profiler trace hooks (a Chrome trace of the host and the
GPU) and a step-time / audio-throughput tracker for the north-star
audio-seconds/s metric. `MetricWriter` and `StepTimer` are copies of the JAX
package's `utils/metrics.py`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


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


class StepTimer:
    """Tracks step wall time and derived throughput counters."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.time()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_s(self) -> Optional[float]:
        return sum(self._times) / len(self._times) if self._times else None

    def audio_seconds_per_s(self, audio_seconds_per_step: float) -> Optional[float]:
        m = self.mean_step_s
        return audio_seconds_per_step / m if m else None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler over the block (CPU activities, and CUDA ones where a
    GPU is present); on exit writes a Chrome trace `trace_<pid>_<ms>.json`
    into `log_dir`. Yields the profiler (for `key_averages()`), or None and
    profiles nothing when log_dir is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler traces."""
    import torch

    with torch.profiler.record_function(name):
        yield
