"""Time the training attention kernels (csrc/attention_train.cuh's core,
through the DiT attention half and through packed attention with dropout) of
the tree in the current directory, for comparing two commits on one GPU, one
after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs, three times each on the same
seeded inputs and the same Philox key, `chip_smoke.check_train` for
`dit_attention_train` and `chip_smoke.check_attention_train` for
`attention_train` at the decoder's shape in the trainer (B=32, T=1000), f32
and bf16, dropout 0.1 and 0. It prints one JSON line: for the forward and
the backward kernel the median ms of each run and the rel err against the
plain version (equal rel errs to the last digit mean the same bits).
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
    b, t = 32, 1000
    for kind in ("dit_attention_train", "attention_train"):
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.1, 0.0):
                if kind == "attention_train":
                    runs = [cs.check_attention_train(b, t, dtype, rate, dev) for _ in range(3)]
                else:
                    runs = [cs.check_train(kind, b, t, dtype, rate, dev) for _ in range(3)]
                for half in range(2):
                    rows = [r[half] for r in runs]
                    out[f"{rows[0]['kernel']} {b}x{t} {rows[0]['dtype']} dropout {rate}"] = {
                        "ms": [r["ms"] for r in rows], "rel_err": rows[0]["rel_err"],
                        "worst_output": rows[0]["worst_output"]}
                torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
