"""Microbenchmark of the packed-head attention path on the GPU, the
counterpart of the JAX package's tools/attn_bench.py, at its shape
[B, T, H=4, D=64] bf16 (B=64, T=1000 unless given).

Times (CUDA events over `iters` calls after a warm-up, ms per call):
  rope        the packed-layout partial RoPE of q and k alone (plain PyTorch)
  kernel      attention_packed (#6) alone
  rope+kernel the two chained, as the composed attention block runs them
  rope_fused  attention_packed_rope (#7): on the card its rotation kernel,
              then the v2 core on the rotated q and k
  variants    kernels named on the command line, each with its rel err
              against attention_packed on the same inputs and its share of
              the bf16 peak (989 TFLOP/s, H100 SXM)

Variants: v2, kt, matmul, nomax, bf16 (attention_variants.cu; the JAX
tool's nomax_bf16 is nomax's math), head_pair, flash_chunks (adapters onto
v2), batch_pair (adapter onto #6).

    python -m stabletts_torch.tools.attn_bench [B T] [variant ...] [--iters N]

`--device cpu` runs every function once through its plain version, for the
tests; it times nothing.
"""

from __future__ import annotations

import argparse
import json

import torch

from stabletts_torch.ops import attention_packed_cuda as ap
from stabletts_torch.ops import attention_variants_cuda as av
from stabletts_torch.utils.device import resolve_device

H, D = 4, 64
PEAK_BF16 = 989e12  # H100 SXM, dense
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
BARS = {torch.float32: 5e-3, torch.bfloat16: 2e-2}


def make_inputs(device, b: int, t: int, dtype=torch.bfloat16, seed: int = 0) -> dict:
    """q, k, v [B, T, H*D] from a seeded generator on `device`; kt = k
    channel-major; mask all valid (the JAX tools' mask) and its key bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, t, H * D, generator=gen, device=device).to(dtype) for _ in range(3))
    mask = torch.ones(b, t, device=device)
    kbias = torch.zeros(b, 1, t, device=device)
    return {"q": q, "k": k, "v": v, "kt": k.transpose(1, 2).contiguous(), "mask": mask, "kbias": kbias}


def _rope(x):
    b, t, c = x["q"].shape
    cos, sin = av.rope_packed_tables(t, H, D, D // 2, x["q"].dtype, x["q"].device)
    return (av.apply_rope_packed(x["q"], cos, sin, H, D // 2), av.apply_rope_packed(x["k"], cos, sin, H, D // 2))


def _rope_fused(x):
    return av.attention_packed_rope(x["q"], x["k"], x["v"], x["mask"], H, D // 2)


VARIANTS = {
    "v2": lambda x: av.attention_packed_v2(x["q"], x["k"], x["v"], x["mask"], H),
    "kt": lambda x: av.attention_packed_kt(x["q"], x["kt"], x["v"], x["mask"], H),
    "matmul": lambda x: av.attention_decompose(x["q"], x["k"], x["v"], "matmul", H),
    "nomax": lambda x: av.attention_decompose(x["q"], x["k"], x["v"], "nomax", H),
    "bf16": lambda x: av.attention_decompose(x["q"], x["k"], x["v"], "bf16", H),
    "head_pair": lambda x: av.attention_head_pair(x["q"], x["k"], x["v"], H),
    "flash_chunks": lambda x: av.attention_flash_chunks(x["q"], x["k"], x["v"], x["mask"], H),
    "batch_pair": lambda x: av.attention_batch_pair(x["q"], x["k"], x["v"], x["kbias"], H),
}


def launch_counts() -> dict:
    """Every kernel counter the tools can reach, by kernel name (#7's
    rotation as "rope_packed")."""
    counts = {"attention_packed": ap.attention_packed.launches,
              "attention_packed_v2": av.attention_packed_v2.launches,
              "attention_packed_rope": av.attention_packed_rope.launches,
              "rope_packed": av.rope_rotate_packed.launches,
              "attention_packed_kt": av.attention_packed_kt.launches}
    counts.update({f"attention_decompose_{m}": n for m, n in av.attention_decompose.launches.items()})
    return counts


def time_ms(fn, device, iters: int):
    """ms per call on the card (CUDA events around `iters` calls after two
    warm-up calls); on the CPU one call and None: nothing is timed there."""
    if device.type != "cuda":
        fn()
        return None
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def attention_flops(b: int, t: int) -> int:
    return 4 * b * H * t * t * D


def bound_ms(flops: float, nbytes: float, dtype) -> float:
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    return max(flops / peak, nbytes / PEAK_BYTES) * 1e3


def variant_row(name: str, fn, x: dict, ref, device, iters: int, **extra) -> dict:
    """One variant: ms, rel err against `ref` (None where the function
    differs by design: the matmul-only mode), share of the peak, bound, and
    the kernel launches it made."""
    q = x["q"]
    b, t, c = q.shape
    before = launch_counts()
    got = fn(x)
    launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    flops = attention_flops(b, t) + (6 * b * t * c if name == "rope_fused" else 0)
    ms = time_ms(lambda: fn(x), device, iters)
    row = {"variant": name, "B": b, "T": t, "dtype": str(q.dtype).replace("torch.", ""), "ms": ms,
           "rel_err": None if name == "matmul" else rel_err(got, ref), "bar": BARS[q.dtype],
           "finite": bool(torch.isfinite(got).all()),
           "peak_share": None if ms is None else flops / (ms * 1e-3) / (PEAK_BF16 if q.dtype == torch.bfloat16
                                                                        else PEAK_F32),
           "bound_ms": bound_ms(flops, 4 * q.numel() * q.element_size(), q.dtype), "launches": launched, **extra}
    return row


def main(device="cuda", b: int = 64, t: int = 1000, variants=(), iters: int = 20, dtype=torch.bfloat16) -> list:
    """Run the benchmark and print one line per row; returns the rows."""
    device = resolve_device(device)
    x = make_inputs(device, b, t, dtype)
    ref = ap.attention_packed(x["q"], x["k"], x["v"], x["mask"], H)
    rope = lambda: _rope(x)
    chained = lambda: ap.attention_packed(*_rope(x), x["v"], x["mask"], H)
    rows = [{"variant": "rope", "ms": time_ms(rope, device, iters)},
            {"variant": "kernel", "ms": time_ms(lambda: ap.attention_packed(x["q"], x["k"], x["v"], x["mask"], H),
                                                device, iters),
             "bound_ms": bound_ms(attention_flops(b, t), 4 * x["q"].numel() * x["q"].element_size(), dtype)},
            {"variant": "rope+kernel", "ms": time_ms(chained, device, iters)}]
    rope_ref = chained()
    rows.append(variant_row("rope_fused", _rope_fused, x, rope_ref, device, iters))
    for name in variants:
        if name not in VARIANTS:
            raise ValueError(f"attn_bench: unknown variant {name!r}; known: {sorted(VARIANTS)}")
        rows.append(variant_row(name, VARIANTS[name], x, ref, device, iters))
    print(f"shape [B={b}, T={t}, H={H}, D={D}] {dtype}, {device}")
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("args", nargs="*", help="[B T] [variant ...]")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=20)
    ns = parser.parse_args()
    sized = len(ns.args) >= 2 and ns.args[0].isdigit() and ns.args[1].isdigit()
    b, t = (int(ns.args[0]), int(ns.args[1])) if sized else (64, 1000)
    main(ns.device, b, t, ns.args[2:] if sized else ns.args, ns.iters)
