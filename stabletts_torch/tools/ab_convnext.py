"""Time the ConvNeXt block (csrc/convnext.cu, #2) of the tree in the current
directory, for comparing two commits on one GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs the block at Vocos's widths
(C = 512, F = 1536) on inputs made here from a seed, so that every tree runs
the same cases with the same code: f32 at a request's vocode (B = 1; T =
313, the frames of the request that `chip_smoke.py` profiles, 1000 and the
mel cap's 1024) and at B = 8, T = 1000, and bf16 at B = 8, T = 1000. It
prints one JSON line: per case the CUDA-event median ms of three runs
("ms"), the plain version's ("plain_ms"), the device ms of one call from
torch.profiler ("device_ms", every kernel the block launches, and
"by_kernel"), the rel err against the plain version and a short hash of the
output ("sha"; equal hashes = equal bits).
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

CASES = [(1, 313, torch.float32), (1, 1000, torch.float32), (1, 1024, torch.float32), (8, 1000, torch.float32),
         (8, 1000, torch.bfloat16)]


def _device_time():
    """tools/device_time.py, loaded from beside this file (the tree under test may lack it)."""
    spec = importlib.util.spec_from_file_location("device_time", os.path.join(os.path.dirname(__file__),
                                                                              "device_time.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from stabletts_torch.ops.convnext_cuda import ConvNeXtWeights, convnext_block, convnext_block_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    device_ms = _device_time()
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    c, f = 512, 1536
    for b, t, dtype in CASES:
        rng = np.random.default_rng(1234)
        g = lambda *s, scale=1.0, off=0.0: torch.from_numpy(
            (rng.standard_normal(s) * scale + off).astype(np.float32)).to(dev, dtype)
        w = ConvNeXtWeights(g(7, c, scale=7 ** -0.5), g(c, scale=0.02), g(c, scale=0.1, off=1.0), g(c, scale=0.02),
                            g(c, f, scale=c ** -0.5), g(f, scale=0.02), g(f, c, scale=f ** -0.5), g(c, scale=0.02),
                            g(c, scale=0.05, off=1.0 / 8))
        x = g(b, t, c)
        run, plain = lambda: convnext_block(x, w), lambda: convnext_block_plain(x, w)
        got = run()
        total, by = device_ms(run)
        out[f"convnext {b}x{t} {cs.DT_NAME[dtype]}"] = {
            "ms": [cs.time_ms(run) for _ in range(3)], "plain_ms": cs.time_ms(plain, iters=5), "device_ms": total,
            "by_kernel": by, "rel_err": cs.rel_err(got, plain())[0],
            "sha": hashlib.sha256(got.float().cpu().numpy().tobytes()).hexdigest()[:16]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
