"""Spreads of the end-to-end metrics over sets of runs, as the bounds are
set from them: for each metric the distance between the first and third
quartile (`statistics.quantiles(values, n=4)`) as a share of the median, per
set, and the median of the numbers compared.

    python3 perfbench/tools/spread.py set1.jsonl set2.jsonl
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench.lib.core import quartile_spread  # noqa: E402


def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip().startswith("{")]


def main(paths):
    for path in paths:
        runs = load(path)
        names = sorted({m for r in runs for m in r["metrics"]})
        print(f"{path}: {len(runs)} runs, correct {sum(r['correct'] for r in runs)}")
        for name in names:
            vals = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if len(vals) < 2:
                continue
            print(f"  {name:28s} median {statistics.median(vals):12.4f}  spread {100 * quartile_spread(vals):7.3f}%  "
                  f"min {min(vals):.4f} max {max(vals):.4f}")
        for name in sorted({c for r in runs for c in r.get("checks", {})}):
            vals = [r["checks"][name]["value"] for r in runs]
            print(f"  check {name:22s} max {max(vals):.4g} (limit {runs[0]['checks'][name]['limit']})")


if __name__ == "__main__":
    main(sys.argv[1:])
