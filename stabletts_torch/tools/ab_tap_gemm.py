"""Time the kernels built on common.cuh's tap GEMM, of the tree in the
current directory, for comparing two commits on one GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs, three times each on the same
seeded inputs, that tree's `chip_smoke` checks at the shapes of PERF.md's
kernel table: #1 `check_dit`, #4 `check_dit_attention` and #5
`check_adaln_ffn` at (2B=16, T=1024), #2 `check_convnext` and #3
`check_istft` at (B=8, T=1000) (#3's product: the tap GEMM in a tree
before the ISTFT head's own kernels, csrc/istft.cu's in one with them),
each in bf16 and f32; the forward and
backward of #11 and #12 (`check_train`, (32, 1000), dropout 0.1) and of #13
(`check_prenet_train`, (32, 1000)), bf16 and f32; and, where the tree has it,
`check_tap_gemm` at the DiT block's four products at (16, 1024) in both
types and in f32 also at a request's (2, 1024) and the training step's
(32, 1000). It prints one JSON line: per case the median ms of each run, the
rel err against the plain version, the library call's ms where the case has
one, and a short hash of the kernel's output on the case's inputs ("sha",
for the cases that `chip_smoke.measure` times); per f32 bare tap GEMM case
the device ms of one launch from torch.profiler ("device_ms", the kernel's own
time: a request's products run shorter than the host takes to issue a call,
which the CUDA-event times above include); and for the f32 #11-#13 the
hash of each output of one forward and one backward launch (the weight-
gradient A/B's `_backward_bits`, loaded from beside this file so that both
trees are hashed by the same code). Equal hashes mean equal bits.
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch


def _sha(out) -> str:
    ts = out if isinstance(out, (tuple, list)) else (out,)
    h = hashlib.sha1()
    for t in ts:
        if isinstance(t, torch.Tensor):
            h.update(t.detach().float().contiguous().cpu().numpy().tobytes())  # bf16 -> f32 is exact
    return h.hexdigest()[:12]


def _hashing(measure):
    """chip_smoke.measure with the hash of one kernel run's output in the row."""
    def wrapped(kernel, dtype, shape, run, run_plain, *a, **k):
        row = measure(kernel, dtype, shape, run, run_plain, *a, **k)
        row["sha"] = _sha(run())
        return row
    return wrapped


def _device_ms(b: int, t: int, product: str, dev, shapes, calls: int = 20):
    """Device ms of one f32 tap-GEMM call on check_tap_gemm's inputs: the
    tap-GEMM kernels' device time over the launches torch.profiler recorded
    in `calls` calls (it can drop some; None if it kept none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm

    rng = np.random.default_rng(1234)
    taps, k, n = shapes[product]
    a = torch.from_numpy(rng.standard_normal((b * t, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((taps, k, n)) * (taps * k) ** -0.5).astype(np.float32)).to(dev)
    kw = dict(t_in=t, t_out=t, taps=taps, shift0=-(taps // 2), shift_step=1)
    tap_gemm(a, w, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            tap_gemm(a, w, **kw)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "tap_gemm" in e.key]
    launches = sum(e.count for e in events)
    return sum(e.self_device_time_total for e in events) / launches / 1e3 if launches else None


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    cs.measure = _hashing(cs.measure)
    spec = importlib.util.spec_from_file_location("ab_wgrad", os.path.join(os.path.dirname(__file__), "ab_wgrad.py"))
    ab_wgrad = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab_wgrad)

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
    for dtype in (bf, f32):
        for kind in ("dit_attention_train", "ffn_train"):
            cases.append((f"{kind} 32x1000 {cs.DT_NAME[dtype]} dropout 0.1",
                          lambda kind=kind, dtype=dtype: cs.check_train(kind, 32, 1000, dtype, 0.1, dev)))
        cases.append((f"prenet_train 32x1000 {cs.DT_NAME[dtype]}",
                      lambda dtype=dtype: cs.check_prenet_train(32, 1000, dtype, dev)))
    if hasattr(cs, "check_tap_gemm"):
        shapes = [(16, 1024, bf), (16, 1024, f32), (2, 1024, f32), (32, 1000, f32)]
        cases += [(f"tap_gemm {p} {b}x{t} {cs.DT_NAME[dtype]}",
                   lambda p=p, b=b, t=t, dtype=dtype: [cs.check_tap_gemm(rng(), b, t, dtype, dev, p)])
                  for b, t, dtype in shapes for p in cs.TAP_GEMM_SHAPES]
    for label, run in cases:
        runs = [run() for _ in range(3)]
        for i, row in enumerate(runs[0]):
            key = label if len(runs[0]) == 1 else f"{label} {row['kernel'].rsplit('_', 1)[1]}"
            out[key] = {"ms": [r[i]["ms"] for r in runs], "rel_err": row["rel_err"], "ok": all(r[i]["ok"] for r in runs)}
            for k in ("library_ms", "bound_ms", "sha", "tile"):
                if row.get(k) is not None:
                    out[key][k] = row[k]
        torch.cuda.empty_cache()
    if hasattr(cs, "check_tap_gemm"):
        for b, t, dtype in shapes:
            if dtype == f32:
                for p in cs.TAP_GEMM_SHAPES:
                    out[f"tap_gemm {p} {b}x{t} float32"]["device_ms"] = _device_ms(b, t, p, dev, cs.TAP_GEMM_SHAPES)
    for kind in ("dit_attention_train", "ffn_train", "prenet_train"):
        out[f"{kind} bits float32"] = ab_wgrad._backward_bits(kind, f32, dev, cs.rel_err)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
