"""Where the tap GEMM's time goes, on one GPU.

    python -m stabletts_torch.tools.tap_gemm_probe [--iters 50]
    python -m stabletts_torch.tools.tap_gemm_probe --shapes f5
    python -m stabletts_torch.tools.tap_gemm_probe --dtype float32 [--b 2 --t 1024]
    python -m stabletts_torch.tools.tap_gemm_probe --dtype float32 --shapes convnext --b 1 --t 1000

Builds `csrc/tap_gemm.cu` (the tap GEMM of `csrc/common.cuh` with a plain
store epilogue) several times, each from a copy of the sources with one
change to `common.cuh`, and times each build at four products in bf16, mean
of `--iters` back-to-back calls between two CUDA events, two rounds in
opposite orders. `--shapes dit` (the default): StableTTS's DiT block
products (QKV, out-projection, conv1, conv2 at 3 taps) at `--b` x `--t` rows
(default the bench batch's 16 x 1024); `--shapes f5`: F5-TTS's (QKV, out-
projection and the FFN's two dense layers, K 1024-2048) at 16 x 2068 rows
unless `--b` / `--t` say otherwise; `--shapes convnext`: the ConvNeXt
block's two products (Vocos's C = 512 -> F = 1536 and back). The bf16
builds:

  as_built            the kernel as it is (128 x 128 or 128 x 256 tiles by
                      the shape, tap_gemm_bn)
  tile_128, tile_256  the 128 x 128 or the 128 x 256 tile at every N > 128
  no_epilogue         the sums are neither staged nor stored (one conditional
                      store keeps the main loop alive)
  no_loads            the producer starts no TMA load: the products run on
                      whatever the ring holds (their result is meaningless),
                      so this is the main loop's products, hand-overs and
                      epilogue alone (the producer's cp.async copies of
                      shifted A still run)

In float32 (the FMA kernel `tap_gemm_f32_kernel`):

  as_built            the kernel as it is (its tile chosen by the shape)
  one_cta_an_sm       __launch_bounds__ for one CTA an SM: no 128-register cap
  ring_3              a 3-deep ring: the copies two k steps ahead, not three
  tile_64, tile_128   the 64 x 64 or the 128 x 128 tile at every shape

The builds that compute the product are checked against `tap_gemm_plain`. It
prints one JSON line per build and product (ms of each round, TFLOP/s of the
best, the bf16 path and tile, and for the bf16 `as_built` and `no_epilogue`
the rate at which the ring is filled: the A and W tiles of every k step of
every tile, most of them from L2), then the card line. The host launches a call
every ~40 us (shape checks, allocation, ctypes), so products shorter than
that read the host, not the kernel. Nothing of the port calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import torch

SHAPES = {"qkv": (1, 256, 768), "out_proj": (1, 256, 256), "conv1": (3, 256, 1024), "conv2": (3, 1024, 256)}
CONVNEXT_SHAPES = {"convnext_w1": (1, 512, 1536), "convnext_w2": (1, 1536, 512)}
F5_SHAPES = {"f5_qkv": (1, 1024, 3072), "f5_out_proj": (1, 1024, 1024), "f5_ffn1": (1, 1024, 2048),
             "f5_ffn2": (1, 2048, 1024)}
DEFAULT_ROWS = {"dit": (16, 1024), "convnext": (16, 1024), "f5": (16, 2068)}
BM, BK = 128, 64  # the bf16 kernel's tile rows and k step


def _variants(src: str, dtype: str) -> dict:
    def sub(text, pairs):
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"tap_gemm_probe: `{old}` not found once in common.cuh; update the probe")
            text = text.replace(old, new)
        return text

    if dtype == "float32":
        tile = "return 4 * tiles >= 3 * NUM_SMS ? 128 : 64;"
        return {"as_built": src, "one_cta_an_sm": sub(src, [("FG_CTAS_PER_SM = 2;", "FG_CTAS_PER_SM = 1;")]),
                "ring_3": sub(src, [("FG_STAGES = 4;", "FG_STAGES = 3;")]),
                "tile_64": sub(src, [(tile, "return 64;")]), "tile_128": sub(src, [(tile, "return 128;")])}
    width = "return 3 * w256 <= 2 * w128 ? 256 : 128;"
    epilogue = "    // epilogue: 64 x 64 sub-tile q holds columns n0 + 64 q .."
    no_epi = [(epilogue, "    if (acc[0] == 1234.5f) epi.store(m0, n0, sub, 0, 0);\n    continue;\n" + epilogue)]
    no_loads = [("const uint32_t tx = (path == TAP_TMA ? S::A_BYTES : 0) + S::B_BYTES;", "const uint32_t tx = 0;"),
                ("          tp_tma_loads<BN>(", "          if (tx) tp_tma_loads<BN>(")]
    return {"as_built": src, "tile_128": sub(src, [(width, "return 128;")]),
            "tile_256": sub(src, [(width, "return 256;")]), "no_epilogue": sub(src, no_epi),
            "no_loads": sub(src, no_loads)}


def _build_variants(_build, dtype: str) -> dict:
    src = open(os.path.join(_build.CSRC_DIR, "common.cuh")).read()
    procs = {}
    for name, text in _variants(src, dtype).items():
        d = os.path.join(_build.BUILD_DIR, "probe", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        with open(os.path.join(d, "common.cuh"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "libtap_gemm.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", lib, os.path.join(d, "tap_gemm.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _loop_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--b", type=int)
    ap.add_argument("--t", type=int)
    ap.add_argument("--shapes", choices=("dit", "convnext", "f5"), default="dit")
    args = ap.parse_args()
    shapes = {"dit": SHAPES, "convnext": CONVNEXT_SHAPES, "f5": F5_SHAPES}[args.shapes]
    b = args.b or DEFAULT_ROWS[args.shapes][0]
    t = args.t or DEFAULT_ROWS[args.shapes][1]
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("tap_gemm_probe measures the kernel on a GPU; none is present")
    from stabletts_torch.ops import _build
    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm, tap_gemm_plain, tap_gemm_route, tap_gemm_tile

    _build.build_all()
    libs = _build_variants(_build, args.dtype)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    inputs = {}
    for prod, (taps, k, n) in shapes.items():
        a = torch.from_numpy(rng.standard_normal((b * t, k)).astype(np.float32)).to(dev, dtype)
        w = torch.from_numpy((rng.standard_normal((taps, k, n)) * (taps * k) ** -0.5).astype(np.float32))
        kw = dict(t_in=t, t_out=t, taps=taps, shift0=-(taps // 2), shift_step=1)
        inputs[prod] = (a, w.to(dev, dtype), kw)
    rows = {}
    for order in (list(libs), list(reversed(libs))):
        for name in order:
            _build._libs["tap_gemm"] = libs[name]
            for prod, (a, w, kw) in inputs.items():
                row = rows.setdefault((name, prod), {"build": name, "dtype": args.dtype, "B": b, "T": t,
                                                     "product": prod, "ms": []})
                row["ms"].append(_loop_ms(lambda: tap_gemm(a, w, **kw), args.iters))
                if "tile" not in row:
                    row["tile"] = tap_gemm_tile(b * t, w.shape[2], dtype)
                    if dtype == torch.bfloat16:
                        row["path"] = tap_gemm_route(a, w, **kw)[0]
                if "rel_err" not in row and not name.startswith("no_"):
                    got, want = tap_gemm(a, w, **kw).float(), tap_gemm_plain(a, w, **kw).float()
                    row["rel_err"] = ((got - want).abs().max() / want.abs().max()).item()
    for (name, prod), row in rows.items():
        taps, k, n = shapes[prod]
        best = min(row["ms"])
        row["tflops"] = 2 * b * t * k * n * taps / best / 1e9
        if name in ("no_epilogue", "as_built") and dtype == torch.bfloat16:
            bn = int(row["tile"].split("x")[1])
            tiles = -(-b * t // BM) * -(-n // bn)
            ring_bytes = tiles * taps * -(-k // BK) * (BM + bn) * BK * 2  # A and W tiles of every k step
            row["ring_fill_GB_per_s"] = ring_bytes / best / 1e6
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(smi or torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
