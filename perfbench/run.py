"""Runs one benchmark cell once and prints its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (kernel build or load, weights from the seed, models, traffic, one
warm call of every shape the window runs) is `setup_s`, from process start
to the first timed call. The window then drives the cell's entry for
`--seconds` and drains what is in flight. `--trace 0` prints the cell's
end-to-end metrics; `--trace 1` runs the window under torch.profiler with
ranges around the configuration's named modules and prints the per-layer
metrics, `busy_s`, `window_s` and a breakdown. After the window the program
is freed and the sampled outputs are compared with the plain reference; the
numbers compared, each beside its limit, end standard error and the result
line. The last line of standard output is the JSON result.

Exits non-zero with no result when no CUDA device (or fewer than the cell
asks for) is present, or when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

import time

T_START = time.time()

import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))

from perfbench.lib import core  # noqa: E402


def run(cell: "core.Cell", seed: int, seconds: float, trace: bool, device: str = "cuda", t_start: float = None,
        after_check=None) -> dict:
    """One run of `cell` on `device`; returns the result dict (without
    printing). `after_check(driver)`, where given, runs once the comparison
    is made (the control tool reads the control's numbers there)."""
    import torch

    from perfbench.lib import trace as tracing

    t_start = time.time() if t_start is None else t_start
    torch.set_num_threads(2)  # one process with few threads: the host's share of a run stays steady
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = cell.entry_module().Driver(cell, seed, device, cell.traffic_module())
    before_setup_s = time.time() - t_start
    info = driver.setup()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - t_start

    ranges, prof = None, None
    if trace:
        ranges = tracing.ModuleRanges(driver.module_roots(), driver.trace_modules)
        prof = tracing.profiler()
        prof.__enter__()
    length = seconds if not trace else min(seconds, cell.workload.get("trace_seconds", seconds))
    gc.collect()
    if hasattr(driver, "begin"):
        driver.begin(length)
    t0 = time.time()
    while time.time() - t0 < length:
        driver.step()
    driver.finish()
    if on_card:
        torch.cuda.synchronize()
    window_s = time.time() - t0
    summary = None
    if trace:
        prof.__exit__(None, None, None)
        ranges.close()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics = {}
    if trace:
        summary = tracing.summarize(prof, window_s)
        del prof
        ctx = {"trace": summary, "work": driver.work(), "window_s": window_s, "cell": cell}
        readers = cell.metric_readers()
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(window_s)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    attempted, failed = driver.attempted()

    driver.release()
    readings = driver.check()
    if after_check is not None:
        after_check(driver)
    limits = cell.workload["limits"]
    checks = [{"name": k, "value": readings[k], "limit": limits[k]} for k in limits]
    correct = all(c["value"] <= c["limit"] for c in checks)

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = tracing.breakdown(summary)
    result["info"] = {"window_s": window_s, "card": card_line(on_card), "imports_s": before_setup_s, **info,
                      **(driver.window_info() if hasattr(driver, "window_info") else {})}
    result["checks"] = core.check_line(checks)
    return result


def card_line(on_card: bool) -> str:
    if not on_card:
        return "cpu"
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    return smi[0] if smi else "unknown"


def main(argv=None) -> int:
    args = core.parse_args(argv)
    cell = core.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = core.forbidden_loaded()
    if found:
        print(f"perfbench: forbidden modules loaded in the benchmark process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
