"""Finds the rate an open-loop request cell sustains: runs the cell once at
each offered rate (requests a second, overriding the workload's
`rate_per_s`) and prints the latency percentiles, the rate served, the
queue's wait and the backlog's growth (the window's last quarter's mean
latency over its first quarter's). Not run by the benchmark's own runs.

    python3 perfbench/tools/sweep.py --workload serve_request_f32 --seconds 20 --seed 7 --rates 10 12 14 16
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench.lib import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    run = core.load_module(os.path.join(ROOT, "perfbench", "run.py"), "perfbench_run")
    for rate in args.rates:
        cell = core.Cell(args.workload)
        cell.workload["traffic"]["rate_per_s"] = rate
        res = run.run(cell, args.seed, args.seconds, False, "cuda")
        print(json.dumps({"rate_per_s": rate, "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "attempted": res["attempted"], "info": res["info"]}), flush=True)


if __name__ == "__main__":
    main()
