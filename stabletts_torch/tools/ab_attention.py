"""Time the kernels built on the shared attention core (csrc/attention.cuh)
of the tree in the current directory, for comparing two commits on one GPU,
one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs, three times each on the same
seeded inputs, `chip_smoke.check_attention_packed` (#6, and #8 with
tminor) at (2B=16, T=1024) bf16 and f32 with a ragged mask and at (2, 97)
bf16, `chip_smoke.check_dit` (#1) at (16, 1024) bf16 and f32, and
`chip_smoke.check_attention_variant` for #9 (`attention_packed_v2`) and #7
(`attention_packed_rope`) at the attention tools' (B=64, T=1000), every key
valid, bf16 and f32. It prints one JSON line: the median ms of each run and
the rel err against the plain version (equal rel errs mean the same bits).
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
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    cases = [("attention_packed", tminor, b, t, dtype) for tminor in (False, True)
             for b, t, dtype in ((16, 1024, torch.bfloat16), (16, 1024, torch.float32), (2, 97, torch.bfloat16))]
    cases += [("dit_block", False, 16, 1024, dtype) for dtype in (torch.bfloat16, torch.float32)]
    cases += [(kind, False, 64, 1000, dtype) for kind in ("attention_packed_v2", "attention_packed_rope")
              for dtype in (torch.bfloat16, torch.float32)]
    for kind, tminor, b, t, dtype in cases:
        if kind == "dit_block":
            run = lambda: cs.check_dit(np.random.default_rng(1234), b=b, t=t, dtype=dtype, dev=dev)
        elif kind != "attention_packed":
            run = lambda: cs.check_attention_variant(np.random.default_rng(1234), kind, b, t, dtype, dev, False)
        else:
            run = lambda: cs.check_attention_packed(np.random.default_rng(1234), b=b, t=t, dtype=dtype, dev=dev,
                                                    masked=True, tminor=tminor)
        rows = [run() for _ in range(3)]
        out[f"{rows[0]['kernel']} {b}x{t} {rows[0]['dtype']}"] = {"ms": [r["ms"] for r in rows],
                                                                  "rel_err": rows[0]["rel_err"]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
