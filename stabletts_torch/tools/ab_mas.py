"""Time the MAS kernel (`ops/mas_cuda.py::maximum_path_cuda`, csrc/mas.cu,
#14) of the tree in the current directory, for comparing two commits on one
GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs MAS at the trainer's shapes,
[32, 1000, 384] and [32, 1000, 512] with the ragged lengths `chip_smoke.py`
draws for them, and at the shapes that run each form of the redesigned
kernel (four chain warps with the decision bits in shared memory and in the
workspace, five warps of 32 cells a lane, one warp with 4-byte copies), on
neg_cent made here from a seed, so that every tree runs the same cases with
the same code. It prints one JSON line: per case the CUDA-event median ms
of three runs ("ms"), the device ms of one call from torch.profiler
("device_ms", every kernel the call launches, and "by_kernel"), the cells
that differ from the plain version and a short hash of the path ("sha";
equal hashes = equal bits).
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

FORMS = [(4, 1000, 1024, [1000, 1000, 950, 300], [1024, 900, 1, 1000]),
         (2, 2000, 1024, [2000, 2000], [1024, 1]),
         (2, 300, 5000, [300, 300], [4200, 290]),
         (4, 301, 77, [301, 250, 77, 30], [77, 61, 77, 50])]


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
    from stabletts_torch.ops.mas import maximum_path
    from stabletts_torch.ops.mas_cuda import maximum_path_cuda

    dev = torch.device("cuda")
    device_ms = _device_time()
    rng = np.random.default_rng(5)
    cases = []
    for tx in (384, 512):  # chip_smoke.py's draws
        t_ys = rng.integers(901, 1001, size=32)
        t_xs = np.minimum(rng.integers(tx // 3, tx + 1, size=32), t_ys)
        t_xs[0] = tx
        cases.append((32, 1000, tx, t_ys.tolist(), t_xs.tolist()))
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    for b, ty, tx, t_ys, t_xs in cases + FORMS:
        neg = torch.from_numpy(np.random.default_rng(ty + tx).standard_normal((b, ty, tx)).astype(np.float32)).to(dev)
        ly, lx = torch.tensor(t_ys, device=dev), torch.tensor(t_xs, device=dev)
        mask = ((torch.arange(ty, device=dev)[None, :] < ly[:, None])[:, :, None]
                & (torch.arange(tx, device=dev)[None, :] < lx[:, None])[:, None, :]).float()
        run = lambda: maximum_path_cuda(neg, mask)
        got = run()
        total, by = device_ms(run, calls=5)
        out[f"mas {b}x{ty}x{tx}"] = {
            "ms": [cs.time_ms(run) for _ in range(3)], "device_ms": total, "by_kernel": by,
            "cells_differing": int((got != maximum_path(neg, mask)).sum()),
            "sha": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
