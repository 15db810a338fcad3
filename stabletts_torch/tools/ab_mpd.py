"""Time the MPD period stack (`ops/mpd_cuda.py::mpd_stack`, csrc/mpd_stack.cu,
#15) of the tree in the current directory, for comparing two commits on one
GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs the stack for the five periods
of the MPD (2, 3, 5, 7, 11) at the GAN trainer's batch [16, 20480] and at
[2, 8190], on audio and `DiscriminatorP` weights made here from seeds, so
that every tree runs the same cases with the same code. It prints one JSON
line: per case the CUDA-event median ms of three runs ("ms"), the device ms
of one call from torch.profiler ("device_ms", every kernel the call
launches, and "by_kernel"), the max-abs error against the plain version and
a short hash of the logits and of each feature map f1-f5 ("sha"; equal
hashes = equal bits).
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

SHAPES = [(16, 20480), (2, 8190)]
PERIODS = (2, 3, 5, 7, 11)


def _device_time():
    """tools/device_time.py, loaded from beside this file (the tree under test may lack it)."""
    spec = importlib.util.spec_from_file_location("device_time", os.path.join(os.path.dirname(__file__),
                                                                              "device_time.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.float().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from stabletts_torch.models.discriminators import DiscriminatorP
    from stabletts_torch.ops.mpd_cuda import mpd_stack, mpd_stack_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    device_ms = _device_time()
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    for b, t in SHAPES:
        x = torch.from_numpy((np.random.default_rng(t).standard_normal((b, t)) * 0.3).astype(np.float32)).to(dev)
        for period in PERIODS:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(period)
                disc = DiscriminatorP(period).to(dev)
            with torch.no_grad():
                folded = disc.fold()
            run = lambda: mpd_stack(x, folded, period)
            logits, fmap = run()
            with torch.no_grad():
                p_logits, p_fmap = mpd_stack_plain(x, folded, period)
            err = max(float((a - r).abs().max()) for a, r in zip([logits, *fmap], [p_logits, *p_fmap]))
            total, by = device_ms(run, calls=5)
            out[f"mpd_stack {b}x{t} p{period}"] = {
                "ms": [cs.time_ms(run, iters=5) for _ in range(3)], "device_ms": total, "by_kernel": by,
                "max_abs_err": err, "sha": {name: _sha(v) for name, v in
                                            zip(("logits", "f1", "f2", "f3", "f4", "f5"), [logits, *fmap])}}
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
