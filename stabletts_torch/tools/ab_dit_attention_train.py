"""Time the training attention-half kernels of the tree in the current
directory, for comparing two commits on one GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels, runs `chip_smoke.check_train` for
`dit_attention_train` three times at (B=32, T=1000) f32 and (32, 1024) bf16,
dropout 0.1, on the same seeded inputs and the same Philox key, and prints one
JSON line: for the forward and the backward kernel the median ms of each run
and the rel err against the plain version (equal rel errs to the last digit
mean the same bits).
"""

import json
import os
import sys

import torch


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    for b, t, dtype in ((32, 1000, torch.float32), (32, 1024, torch.bfloat16)):
        runs = [cs.check_train("dit_attention_train", b, t, dtype, 0.1, dev) for _ in range(3)]
        for half in range(2):
            rows = [r[half] for r in runs]
            out[f"{rows[0]['kernel']} {b}x{t} {rows[0]['dtype']}"] = {
                "ms": [r["ms"] for r in rows], "rel_err": rows[0]["rel_err"], "worst_output": rows[0]["worst_output"]}
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
