"""Time the kernels built on common.cuh's tap GEMM, of the tree in the
current directory, for comparing two commits on one GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs, three times each on the same
seeded inputs, that tree's `chip_smoke` checks at the shapes of PERF.md's
kernel table: #1 `check_dit`, #4 `check_dit_attention` and #5
`check_adaln_ffn` at (2B=16, T=1024), #2 `check_convnext` and #3
`check_istft` at (B=8, T=1000), each in bf16 and f32; the bf16 forward and
backward of #11 and #12 (`check_train`, (32, 1000), dropout 0.1) and of #13
(`check_prenet_train`, (32, 1000)); and, where the tree has it,
`check_tap_gemm` at the DiT block's four products. It prints one JSON line:
the median ms of each run and the rel err against the plain version (equal
rel errs mean the same bits).
"""

import json
import os
import sys

import numpy as np
import torch


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    rng = lambda: np.random.default_rng(1234)
    cases = []
    for dtype in (bf, f32):
        cases += [(f"{name} 16x1024 {cs.DT_NAME[dtype]}", lambda fn=fn, dtype=dtype: [fn(rng(), 16, 1024, dtype, dev)])
                  for name, fn in (("dit_block", cs.check_dit), ("dit_attention", cs.check_dit_attention),
                                   ("adaln_ffn", cs.check_adaln_ffn))]
        cases += [(f"{name} 8x1000 {cs.DT_NAME[dtype]}", lambda fn=fn, dtype=dtype: [fn(rng(), 8, 1000, dtype, dev)])
                  for name, fn in (("convnext", cs.check_convnext), ("istft", cs.check_istft))]
    for kind in ("dit_attention_train", "ffn_train"):
        cases.append((f"{kind} 32x1000 bfloat16 dropout 0.1",
                      lambda kind=kind: cs.check_train(kind, 32, 1000, bf, 0.1, dev)))
    cases.append(("prenet_train 32x1000 bfloat16", lambda: cs.check_prenet_train(32, 1000, bf, dev)))
    if hasattr(cs, "check_tap_gemm"):
        cases += [(f"tap_gemm {p} 16x1024 {cs.DT_NAME[dtype]}",
                   lambda p=p, dtype=dtype: [cs.check_tap_gemm(rng(), 16, 1024, dtype, dev, p)])
                  for p in cs.TAP_GEMM_SHAPES for dtype in (bf, f32)]
    for label, run in cases:
        runs = [run() for _ in range(3)]
        for i, row in enumerate(runs[0]):
            key = label if len(runs[0]) == 1 else f"{label} {row['kernel'].rsplit('_', 1)[1]}"
            out[key] = {"ms": [r[i]["ms"] for r in runs], "rel_err": row["rel_err"], "ok": all(r[i]["ok"] for r in runs)}
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
