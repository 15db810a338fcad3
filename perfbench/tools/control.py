"""Reads the numbers that a cell's `correct` compares, for the program and
for its control, on several seeds in one process (not run by the
benchmark's own runs).

The program's readings come from a normal run of the cell (window included),
with `--fault` a run with that fault of `faults.py` planted in the program.
The control is the plain reference put in the program's place on the same
sampled inputs, one precision below the configuration's: `fp8` (float8 e4m3
operands) for a bfloat16 cell, `tf32` (TF32 matmuls and convolutions) for a
float32 one. Each seed prints one JSON line.

    python3 perfbench/tools/control.py --workload serve_batch_bf16 --control fp8 --seconds 6 --seeds 1 2 3
    python3 perfbench/tools/control.py --workload train_f32_b32 --fault half_batch --seconds 2 --seeds 1 2 3
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench.lib import core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=("fp8", "tf32", "bf16", "none"), default="none")
    ap.add_argument("--fault", default=None, help="a fault of tools/faults.py planted in the program")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from perfbench.reference.stabletts_ref import Precision

    run = core.load_module(os.path.join(ROOT, "perfbench", "run.py"), "perfbench_run")
    cell = core.Cell(args.workload)
    if args.fault:
        faults = core.load_module(os.path.join(ROOT, "perfbench", "tools", "faults.py"), "perfbench_faults")
        {**faults.SERVING, **faults.TRAINING}[args.fault](setattr)
    for seed in args.seeds:
        control = {}

        def read_control(driver):
            t0 = time.time()
            if args.control == "tf32":
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            if args.control == "none":
                return
            driver.produce_control(Precision(args.control if args.control in ("fp8", "bf16") else "none"))
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            control.update(driver.check())
            control["seconds"] = time.time() - t0

        t0 = time.time()
        res = run.run(cell, seed, args.seconds, False, args.device, after_check=read_control)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault, "correct": res["correct"],
                          "program": {k: v["value"] for k, v in res["checks"].items()},
                          "control": control, "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "run_s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
