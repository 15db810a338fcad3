"""Time the kernels built on the shared attention core (csrc/attention.cuh)
of the tree in the current directory, for comparing two commits on one GPU,
one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs, three times each on the same
seeded inputs, `chip_smoke.check_attention_packed` (#6, and #8 with
tminor) at (2B=16, T=1024) bf16 and f32 with a ragged mask, at (2, 97)
bf16 and at (2, 1024) f32, `chip_smoke.check_dit` (#1) at (16, 1024) bf16
and f32, and `chip_smoke.check_attention_variant` for #9 (`attention_packed_v2`), #7
(`attention_packed_rope`), 17d (`attention_packed_kt`) and 17b
(`attention_decompose` matmul, nomax, bf16) at the attention tools' (B=64,
T=1000), every key valid, bf16 and f32, and for #7 also with chip_smoke's
ragged mask. It prints one JSON line: the median ms of each run, the rel err
against the plain version, a sha256 of the kernel's output on the case's
inputs ("sha"; equal hashes = equal bits) and, with a mask, of its valid
query rows ("sha_valid"); for the (64, 1000) cases also one call's device ms
from torch.profiler, in all and by kernel ("device_ms", "by_kernel").

It also runs the f32 serving core at a request's mask (2B = 2, T = 1024, both
items 313 frames long, as a 313-frame sentence pads to the 1024-frame mel
cap): `attention_packed` in both layouts and `dit_block`, each on inputs made
here from a seed (so that a parent tree without these cases runs them too),
with a sha256 of the whole output ("sha") and of its valid query rows
("sha_valid"; equal hashes = equal bits), the median ms of three runs, and
from torch.profiler the device ms of one call ("device_ms", every kernel it
launches) and of its attention core ("core_device_ms", the kernels named
attention_kernel*): a request's core runs shorter than the host takes to
issue a call, which the CUDA-event times include. The same for one
scaled_dot_product_attention call with the same key mask ("sdpa request").
"""

import hashlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

REQUEST_T, REQUEST_LEN = 1024, 313


def sha(x: torch.Tensor) -> str:
    return hashlib.sha256(x.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]


def _device_time():
    """tools/device_time.py, loaded from beside this file (the tree under test may lack it)."""
    spec = importlib.util.spec_from_file_location("device_time", os.path.join(os.path.dirname(__file__),
                                                                              "device_time.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def request_cases(cs, dev) -> dict:
    """The f32 serving core at a request's mask; see the module docstring."""
    import torch.nn.functional as F

    from stabletts_torch.ops import attention_packed_cuda as ap
    from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block

    rng = np.random.default_rng(1234)
    b, t, c, f, heads = 2, REQUEST_T, 256, 1024, 4
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev)
    mask = (torch.arange(t, device=dev)[None, :] < REQUEST_LEN).float().repeat(b, 1)
    valid = mask > 0
    q, k, v = g(b, t, c), g(b, t, c), g(b, t, c)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    w = DiTWeights(g(c, 3 * c, scale=c ** -0.5), g(3 * c, scale=0.02), g(c, c, scale=c ** -0.5), g(c, scale=0.02),
                   g(3, c, f, scale=(3 * c) ** -0.5), g(f, scale=0.02), g(3, f, c, scale=(3 * f) ** -0.5),
                   g(c, scale=0.02))
    x = g(b, t, c) * mask[..., None]
    mods = g(b, 6, c, scale=0.1)
    bhtd = lambda a: a.view(b, t, heads, 64).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(bhtd(q), bhtd(k), bhtd(v), attn_mask=valid[:, None, None, :])
    runs = {"attention_packed": (lambda: ap.attention_packed(q, k, v, mask, n_heads=heads), lambda o: o[valid]),
            "attention_packed_t": (lambda: ap.attention_packed_t(qt, kt, vt, mask, n_heads=heads),
                                   lambda o: o.transpose(1, 2)[valid]),
            "dit_block": (lambda: dit_block(x, mods, mask, w, heads), lambda o: o[valid])}
    device_ms = _device_time()
    out = {}
    for name, (fn, rows) in runs.items():
        o = fn()
        total, by = device_ms(fn)
        core = sum(ms for kernel, ms in by.items() if "attention_kernel" in kernel)
        out[f"{name} request {b}x{t} float32"] = {"ms": [cs.time_ms(fn) for _ in range(3)], "device_ms": total,
                                                   "core_device_ms": core, "sha": sha(o), "sha_valid": sha(rows(o)),
                                                   "finite": bool(torch.isfinite(o).all())}
    out[f"sdpa request {b}x{t} float32"] = {"ms": [cs.time_ms(sdpa) for _ in range(3)], "device_ms": device_ms(sdpa)[0]}
    return out


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    # (kind, flag, b, t, dtype): the flag is tminor for attention_packed, the ragged mask for a variant
    cases = [("attention_packed", tminor, b, t, dtype) for tminor in (False, True)
             for b, t, dtype in ((16, 1024, torch.bfloat16), (16, 1024, torch.float32), (2, 97, torch.bfloat16),
                                 (2, 1024, torch.float32))]
    cases += [("dit_block", False, 16, 1024, dtype) for dtype in (torch.bfloat16, torch.float32)]
    cases += [(kind, False, 64, 1000, dtype)
              for kind in ("attention_packed_v2", "attention_packed_rope", "attention_packed_kt",
                           "attention_decompose_matmul", "attention_decompose_nomax", "attention_decompose_bf16")
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [("attention_packed_rope", True, 64, 1000, dtype) for dtype in (torch.bfloat16, torch.float32)]
    measure, device_ms = cs.measure, _device_time()

    def measure_with_sha(*args, **kw):  # also the hash of the kernel's output (run, args[3]) on the case's inputs
        row = measure(*args, **kw)
        o = args[3]()
        row["sha"] = sha(o)
        if kw.get("select") is not None:
            row["sha_valid"] = sha(kw["select"](o))
        if args[2].get("B") == 64:
            row["device_ms"], row["by_kernel"] = device_ms(args[3], calls=5)
        return row

    cs.measure = measure_with_sha
    for kind, flag, b, t, dtype in cases:
        if kind == "dit_block":
            run = lambda: cs.check_dit(np.random.default_rng(1234), b=b, t=t, dtype=dtype, dev=dev)
        elif kind != "attention_packed":
            run = lambda: cs.check_attention_variant(np.random.default_rng(1234), kind, b, t, dtype, dev, flag)
        else:
            run = lambda: cs.check_attention_packed(np.random.default_rng(1234), b=b, t=t, dtype=dtype, dev=dev,
                                                    masked=True, tminor=flag)
        rows = [run() for _ in range(3)]
        masked = " masked" if kind.startswith("attention_packed_") and flag else ""
        out[f"{rows[0]['kernel']} {b}x{t} {rows[0]['dtype']}{masked}"] = {
            "ms": [r["ms"] for r in rows], "rel_err": rows[0]["rel_err"], "sha": rows[0]["sha"],
            **{key: rows[0][key] for key in ("sha_valid", "device_ms", "by_kernel") if key in rows[0]}}
    out.update(request_cases(cs, dev))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
