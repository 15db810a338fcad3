"""The harness's plumbing: arguments, the cell's files found by name, the
statistics over a window, the import guard and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
lives in a file of its own under `perfbench/`, found by the name that
`BENCHMARK.json` gives:

  configs/<config>.json      sizes, source, `reduced`, `assumed`
  workloads/<cell>.json      configuration, entry, traffic parameters, limits
  traffic/<kind>.py          the generator a workload's `traffic.kind` names
  entries/<entry>.py         the driver of the program's entry point
  metrics/<metric>.py        one reader per per-layer metric
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
from types import ModuleType

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG_DIR)

# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "stabletts_tpu")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """A Python file loaded by its path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of BENCHMARK.json with its configuration, workload file and
    the metrics it reports."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.pkg = os.path.join(root, "perfbench")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.workload = load_json(os.path.join(self.pkg, "workloads", f"{name}.json"))
        self.traffic = self.workload["traffic"]
        self.end_to_end = [m for m in self.bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.bench["per_layer"] if name in m.get("workloads", [name])]

    def entry_module(self) -> ModuleType:
        entry = self.workload["entry"]
        return load_module(os.path.join(self.pkg, "entries", f"{entry}.py"), f"perfbench_entry_{entry}")

    def traffic_module(self) -> ModuleType:
        kind = self.traffic["kind"]
        return load_module(os.path.join(self.pkg, "traffic", f"{kind}.py"), f"perfbench_traffic_{kind}")

    def metric_readers(self) -> dict:
        return {m["name"]: load_module(os.path.join(self.pkg, "metrics", f"{m['name']}.py"),
                                       "perfbench_metric_" + m["name"].replace(".", "_"))
                for m in self.per_layer}


def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, with Python's quantiles."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def percentile(values, pct: float) -> float:
    """The pct-th percentile of all values, linear between order statistics
    (numpy's default), over the whole window's samples."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * pct / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_loaded(modules=None) -> list:
    """Top-level names of FORBIDDEN found in sys.modules, compared whole
    (`stabletts_torch` is not `stabletts_tpu`, nor is `jaxtyping` `jax`)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def check_line(checks: list) -> dict:
    """{name: {"value": v, "limit": l}} of the numbers compared."""
    return {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
