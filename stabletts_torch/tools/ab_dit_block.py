"""Time the whole-block DiT kernel of the tree in the current directory, for
comparing two commits on one GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels, runs `chip_smoke.check_dit` three times
at (2B=16, T=1024) bf16 and f32 and at (2, 1024) f32 on the same seeded
inputs, and hashes `dit_block`'s output (the first 16 hex digits of the
sha256 of its values as f32; equal hashes mean equal bits) at the serving
cells' shapes: StableTTS's estimator batch [192, 1024] and a text-encoder
batch [96, 279] in bf16, F5-TTS's [16, 2068, 1024] (16 heads, F 2048, one-tap
FFN) in bf16, all ragged, and a request's [2, 1024] in f32 with 313 valid
frames; with the CUDA-event median ms of each. It prints one JSON line: the
check_dit rows' median ms of each run and rel err against the plain version
(equal rel errs mean the same bits), then the hashes.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch

# (form, B, T, dtype, mask): the hashed cases
HASH_CASES = (("stabletts", 192, 1024, torch.bfloat16, "ragged"), ("stabletts", 96, 279, torch.bfloat16, "ragged"),
              ("f5tts", 16, 2068, torch.bfloat16, "ragged"), ("stabletts", 2, 1024, torch.float32, "request"))


def _ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[1]


def _hash_case(cs, form, b, t, dtype, mask_kind, dev) -> dict:
    """dit_block's output on inputs drawn as check_dit draws them (seed 1234)."""
    from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block

    rng = np.random.default_rng(1234)
    c, f, heads, taps, kw = cs.DIT_FORMS[form]
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    w = DiTWeights(g(c, 3 * c, scale=c ** -0.5), g(3 * c, scale=0.02), g(c, c, scale=c ** -0.5),
                   g(c, scale=0.02), g(taps, c, f, scale=(taps * c) ** -0.5), g(f, scale=0.02),
                   g(taps, f, c, scale=(taps * f) ** -0.5), g(c, scale=0.02))
    mask = cs._mask(mask_kind, b, t, dev)
    x = g(b, t, c) * mask[..., None].to(dtype)
    mods = g(b, 6, c, scale=0.1)
    out = dit_block(x, mods, mask, w, heads, **kw)
    sha = hashlib.sha256(out.float().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    return {"sha": sha, "ms": _ms(lambda: dit_block(x, mods, mask, w, heads, **kw))}


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(), "card": torch.cuda.get_device_name(0)}
    for b, t, dtype in ((16, 1024, torch.bfloat16), (16, 1024, torch.float32), (2, 1024, torch.float32)):
        rows = [cs.check_dit(np.random.default_rng(1234), b=b, t=t, dtype=dtype, dev=dev) for _ in range(3)]
        out[f"{b}x{t} {rows[0]['dtype']}"] = {"ms": [r["ms"] for r in rows], "rel_err": rows[0]["rel_err"]}
    for form, b, t, dtype, mask_kind in HASH_CASES:
        out[f"{form} [{b}, {t}] {cs.DT_NAME[dtype]} {mask_kind}"] = _hash_case(cs, form, b, t, dtype, mask_kind, dev)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
