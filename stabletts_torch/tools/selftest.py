"""The serving bench's gate: the three kernels the bench launches against
their plain versions on the card, at small shapes, f32 and bf16.

The counterpart of the JAX package's tools/tpu_selftest.py as the gate in
front of bench.py (bench.py:65-78). A broken kernel fails the bench instead
of giving a wrong but fast number. Checked, each at its bar from
`stabletts_torch/ops/bars.py` (the bars chip_smoke.py holds them to):

  dit_block  #1, [3, 200, 256] with a ragged mask (C=256, F=1024, 4 heads)
  convnext   #2, [3, 200, 512] (F=1536)
  istft      #3, [3, 64, 1025] (n_fft 2048, hop 512), without and with
             per-item lengths

    python -m stabletts_torch.tools.selftest      # one JSON line a check, then SELFTEST OK or FAILED

Each kernel is reached through its module's attribute at call time, so a
wrapper replaced on the module is the one checked. On the CPU every wrapper
takes its plain version, so the checks there test the gate alone.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from stabletts_torch.ops import convnext_cuda, dit_block_cuda, istft_cuda
from stabletts_torch.ops.bars import BARS
from stabletts_torch.utils.device import resolve_device

B, T = 3, 200
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _rand(rng, dev, dtype, *shape, scale=1.0, off=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + off).astype(np.float32)).to(dev, dtype)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|; inf where got is not finite."""
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def _ragged_mask(b: int, t: int, dev) -> torch.Tensor:
    lengths = torch.tensor([t - (i * 37) % max(1, t // 2) for i in range(b)], device=dev)
    return (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()


def check_dit_block(rng, dtype, dev) -> dict:
    c, f, heads = 256, 1024, 4
    g = lambda *s, scale=1.0: _rand(rng, dev, dtype, *s, scale=scale)
    w = dit_block_cuda.DiTWeights(g(c, 3 * c, scale=c ** -0.5), g(3 * c, scale=0.02), g(c, c, scale=c ** -0.5),
                                  g(c, scale=0.02), g(3, c, f, scale=(3 * c) ** -0.5), g(f, scale=0.02),
                                  g(3, f, c, scale=(3 * f) ** -0.5), g(c, scale=0.02))
    mask = _ragged_mask(B, T, dev)
    x = g(B, T, c) * mask[..., None].to(dtype)
    mods = g(B, 6, c, scale=0.1)
    got = dit_block_cuda.dit_block(x, mods, mask, w, heads)
    return {"kernel": "dit_block", "shape": [B, T, c], "rel_err": rel_err(got, dit_block_cuda.dit_block_plain(
        x, mods, mask, w, heads))}


def check_convnext(rng, dtype, dev) -> dict:
    c, f = 512, 1536
    g = lambda *s, scale=1.0, off=0.0: _rand(rng, dev, dtype, *s, scale=scale, off=off)
    w = convnext_cuda.ConvNeXtWeights(g(7, c, scale=7 ** -0.5), g(c, scale=0.02), g(c, scale=0.1, off=1.0),
                                      g(c, scale=0.02), g(c, f, scale=c ** -0.5), g(f, scale=0.02),
                                      g(f, c, scale=f ** -0.5), g(c, scale=0.02), g(c, scale=0.05, off=1.0 / 8))
    x = g(B, T, c)
    got = convnext_cuda.convnext_block(x, w)
    return {"kernel": "convnext", "shape": [B, T, c], "rel_err": rel_err(got, convnext_cuda.convnext_block_plain(x, w))}


def check_istft(rng, dtype, dev, with_lengths: bool) -> dict:
    n_fft, hop, t = 2048, 512, 64
    nf = n_fft // 2 + 1
    mag = np.exp(np.clip(rng.standard_normal((B, t, nf)), None, math.log(100.0)))
    phase = rng.uniform(-np.pi, np.pi, (B, t, nf))
    re = torch.from_numpy((mag * np.cos(phase)).astype(np.float32)).to(dev)
    im = torch.from_numpy((mag * np.sin(phase)).astype(np.float32)).to(dev)
    lengths = torch.tensor([t - 11 * i for i in range(B)], device=dev) if with_lengths else None
    md = None if dtype == torch.float32 else dtype
    got = istft_cuda.istft_head(re, im, n_fft, hop, md, lengths)
    frame_mask = None if lengths is None else (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()
    want = istft_cuda.istft_same_real(re, im, n_fft, hop, n_fft, md, frame_mask)
    return {"kernel": "istft", "shape": [B, t, nf], "lengths": with_lengths, "rel_err": rel_err(got, want)}


def run(device=None) -> list:
    """Every check in f32 and bf16 on `device` (the GPU unless the caller
    passes "cpu"); one row each, with its bar and "ok"."""
    dev = resolve_device(device)
    rng = np.random.default_rng(2024)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        checks = [check_dit_block(rng, dtype, dev), check_convnext(rng, dtype, dev),
                  check_istft(rng, dtype, dev, False), check_istft(rng, dtype, dev, True)]
        for row in checks:
            bar = BARS[row["kernel"]][dtype]
            rows.append({**row, "dtype": DT_NAME[dtype], "bar": bar, "ok": row["rel_err"] <= bar})
    return rows


def main(argv=None) -> list:
    """Prints one JSON line a check and SELFTEST OK; exits with 1 (SystemExit)
    if a check is over its bar. Returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    rows = run(args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    bad = [f"{r['kernel']} {r['dtype']}" for r in rows if not r["ok"]]
    if bad:
        print(f"SELFTEST FAILED: {', '.join(bad)}", flush=True)
        raise SystemExit(1)
    print("SELFTEST OK", flush=True)
    return rows


if __name__ == "__main__":
    main()
