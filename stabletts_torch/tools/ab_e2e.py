"""Time the port end to end, of the tree in the current directory, for
comparing two commits on one GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs that tree's `chip_smoke`
phases at the flagship config (random weights from a seed): `phase_serving`
(three f32 `StableTTSAPI.inference` requests, one batch request and the bf16
bench batch), then `--reps` more f32 requests of the 313-frame sentence and
bench batches, timed by the host clock around a call that ends on the host;
`phase_profile` of that request (device busy ms, the idle share, the device
ms by the tree's kernel families and the largest kernels); and
`phase_train_steps` (f32 `train()` at B=32, T <= 1000, steady median),
`phase_train_bf16` (the same in bf16) and `phase_profile` of one f32 step of
`phase_train_overfit`'s model (device busy ms, the idle share, the largest
kernels and the training attention core's device ms by kernel). It prints one
JSON line: the wall ms of each request and batch, the profiles' numbers, the
training steps' steady medians, and sha256 prefixes of the serving outputs
(equal hashes = equal bits): the request's mel, each item's waveform of an
f32 `batch_inference` of the phase's sentences, and each item's waveform of
the bf16 bench batch. The phases' own lines are not printed.
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=os.getcwd())
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from stabletts_torch.ops import _build

    lines = []
    cs.emit = lines.append  # the phases report through chip_smoke.emit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    card = torch.cuda.get_device_name(0)
    api, _, pipeline = cs.phase_serving(dev, card)
    ref = cs.reference_wave(5)
    request = lambda: api.inference(cs.SENTENCES[2], ref, "english", step=10, cfg=3.0)
    walls = {"request_f32": [], "bench_bf16": []}
    for _ in range(args.reps):
        for name, fn in (("request_f32", request), ("bench_bf16", pipeline)):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn()
            if isinstance(out, torch.Tensor):
                out.cpu()
            walls[name].append((time.time() - t0) * 1e3)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]
    hashes = {"request_f32_mel": sha(request()[1]),
              "batch_f32_wav": [sha(w) for w in api.batch_inference([(s, "english") for s in cs.SENTENCES], ref,
                                                                     step=10, cfg=3.0)],
              "bench_bf16_wav": [sha(w.float().cpu().numpy()) for w in pipeline()]}
    cs.phase_profile("request_f32", request, card)
    with tempfile.TemporaryDirectory() as root:
        _, f32_loss, f32_wall = cs.phase_train_steps(dev, card, root)
        cs.phase_train_bf16(dev, card, root, f32_loss, f32_wall)
        step_fn, _ = cs.phase_train_overfit(dev, card, root)
        step_fn()
        cs.phase_profile("train_step", step_fn, card)
    by_phase = {}
    for line in lines:
        by_phase.setdefault(line.get("phase"), []).append(line)
    prof = by_phase["profile_request_f32"][0]
    out = {"tree": args.tree, "request_f32_wall_ms": walls["request_f32"],
           "bench_bf16_wall_ms": walls["bench_bf16"],
           "serving_request_wall_ms": [r["wall_ms"] for r in by_phase["serving_request"]],
           "serving_bench_bf16_wall_ms": by_phase["serving_bench_bf16"][0]["wall_ms"],
           "profile_request_f32": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                          "kernel_launches", "families_device_ms", "top")},
           "profile_train_step": {k: by_phase["profile_train_step"][0][k] for k in (
               "wall_ms", "device_busy_ms", "device_idle_share", "kernel_launches", "top")},
           # the training attention core's kernels (FMA or wgmma) and D's row sums, from the profile's largest kernels
           "train_step_attention_core_ms": {
               fam: sum(e["device_ms"] for e in by_phase["profile_train_step"][0]["top"] if fam in e["name"])
               for fam in ("attn_fwd_kernel", "attn_bwd_dkv_kernel", "attn_bwd_dq_kernel", "rowdot_kernel")},
           "train_f32_steady_ms": by_phase["train_steps"][0]["steady_wall_ms_median"],
           "train_bf16_steady_ms": by_phase["train_bf16"][0]["steady_wall_ms_median"], "sha": hashes, "card": card}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
