"""The JAX package's five attention experiments (tools/attn_exp.py,
attn_exp2.py ... attn_exp5.py) on the GPU, one function each, at their
shape [B=64, T=1000, H=4, D=64] bf16. Each prints one row per variant: ms,
rel err against attention_packed (#6) on the same inputs, the bound, and
the kernel launches it made.

    python -m stabletts_torch.tools.attn_exp [B T] [--iters N]

`--device cpu` runs every function once through its plain version, for the
tests; it times nothing.
"""

from __future__ import annotations

import argparse
import json

import torch

from stabletts_torch.ops import attention_packed_cuda as ap
from stabletts_torch.tools.attn_bench import H, VARIANTS, make_inputs, variant_row
from stabletts_torch.utils.device import resolve_device


def head_pair(x, ref, device, iters) -> list:
    """tools/attn_exp.py: does pairing two heads against a block-diagonal K
    (a [blk, 128] x [128, 2T] product) beat one head at a time? On the TPU it
    filled the MXU's 128 lanes with two 64-wide heads. A Hopper CTA already
    works on one 64-wide head tile and the block-diagonal zeros would be
    wasted FMAs, so the run times `attention_head_pair`, the adapter onto #9,
    and answers what #9 costs at the experiment's shape without a mask."""
    return [variant_row("head_pair", VARIANTS["head_pair"], x, ref, device, iters, replaces="tools/attn_exp.py:94")]


def decompose(x, ref, device, iters) -> list:
    """tools/attn_exp2.py: how much of the kernel is the two products alone
    (`matmul`: no softmax), what the running max costs (`nomax`; its
    `nomax_bf16` body is the same math) and what bf16 scores buy (`bf16`:
    here a first pass over the keys for the max, then the weights). On the
    H100 the bf16 kernels run both products on wgmma and the f32 ones on
    fp32 FMA, so the answer splits the core into its products and its
    softmax."""
    return [variant_row(w, VARIANTS[w], x, ref, device, iters, replaces="tools/attn_exp2.py:104")
            for w in ("matmul", "nomax", "bf16")]


def flash_chunks(x, ref, device, iters) -> list:
    """tools/attn_exp3.py: does an online softmax over key chunks (blk_q and
    kc sized so the score tile stays in vector registers) beat the whole-row
    softmax? The port's core already is an online softmax over 64-key tiles,
    so the run times `attention_flash_chunks`, the adapter onto #9, with the
    mask: the answer is #9 itself."""
    return [variant_row("flash_chunks", VARIANTS["flash_chunks"], x, ref, device, iters,
                        replaces="tools/attn_exp3.py:86")]


def k_transposed(x, ref, device, iters) -> list:
    """tools/attn_exp4.py: does K given pre-transposed ([B, C, T]) save the
    in-kernel transpose of QK^T? On the H100 the kernel reads the K tile with
    t contiguous either way into the same shared-memory layout, so the answer
    is how the other global-load order compares with #9's."""
    return [variant_row("kt", VARIANTS["kt"], x, ref, device, iters, replaces="tools/attn_exp4.py:71")]


def batch_pair(x, ref, device, iters) -> list:
    """tools/attn_exp5.py: does pairing two batch items against a
    block-diagonal K/V fill the MXU's lanes better? The function is #6's with
    the key bias as a mask, so the run times `attention_batch_pair`, the
    adapter onto #6; its rel err against #6 is 0 by construction."""
    return [variant_row("batch_pair", VARIANTS["batch_pair"], x, ref, device, iters,
                        replaces="tools/attn_exp5.py:103")]


EXPERIMENTS = (head_pair, decompose, flash_chunks, k_transposed, batch_pair)


def main(device="cuda", b: int = 64, t: int = 1000, iters: int = 20, dtype=torch.bfloat16) -> list:
    """Run every experiment and print one line per row; returns the rows."""
    device = resolve_device(device)
    x = make_inputs(device, b, t, dtype)
    ref = ap.attention_packed(x["q"], x["k"], x["v"], x["mask"], H)
    rows = []
    for exp in EXPERIMENTS:
        rows += [{"experiment": exp.__name__, **row} for row in exp(x, ref, device, iters)]
    print(f"shape [B={b}, T={t}, H={H}, D=64] {dtype}, {device}")
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("shape", nargs="*", type=int, help="B T")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=20)
    ns = parser.parse_args()
    b, t = ns.shape if len(ns.shape) == 2 else (64, 1000)
    main(ns.device, b, t, ns.iters)
