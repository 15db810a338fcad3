"""Drive the PyTorch port (stabletts_torch) on one CUDA GPU and check it.

    python3 chip_smoke.py            # one card; exits 0 only if every phase passed

Phases, one JSON line each; any failure exits nonzero:
  1. environment (torch/CUDA versions, card name and power limit)
  2. kernel build (every csrc/*.cu, one nvcc each, in parallel), then the
     `sass` line: HGMMA (wgmma) instructions per library by cuobjdump; every
     library with attention.cuh's bf16 core must have them in that core, both
     libraries with attention_train.cuh's in its three bf16 kernels, every
     library with common.cuh's bf16 tap GEMM in its wgmma kernel, and every
     library with its bf16 weight-gradient GEMM in `wgrad_wgmma_kernel`; no
     library may hold an FMA form of any of them for bf16; then the `ptxas`
     line: registers and spills of every f32 tap-GEMM and weight-gradient
     instantiation, of the f32 attention cores (the serving core under every
     option the callers and the variants set), of #7's rotation and of
     ConvNeXt's depthwise conv + LayerNorm
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes (the serving kernels also at the bench's B=192 in bf16),
     f32 and bf16, with times and bounds and the unit of
     each kernel's products ("core": "wgmma" for bf16 on the attention cores,
     the tap GEMM or the weight-gradient GEMM, else "fma"; "projections" for
     the tap GEMMs beside an attention core; "wgrad" for a backward's
     weight-gradient GEMM, "wgmma" in bf16 and "fma" in f32): the serving
     kernels (the whole DiT block, its attention half and FFN half, packed
     attention in both layouts beside one scaled_dot_product_attention call,
     and in f32 the block and packed attention at a request's mask, at a mask
     with a hole of one key tile and, for packed attention, with an item that
     has no valid key; under a mask the bound counts the valid rows' work,
     ConvNeXt, ISTFT, and the bare tap GEMM at the DiT block's four products
     beside one matmul or conv1d call (in f32 also at a request's 2 x 1024
     rows and the training step's 32 x 1000; each row names its CTA tile,
     "tile"); the bare weight-gradient GEMM at the
     training step's four products at B=32, T=1000 beside one matmul or
     cuDNN convolution_backward call, and the bare column sums beside one
     torch.sum call); the training kernels' forward and
     every gradient at dropout 0 and 0.1 (shared Philox bits); MAS exactly,
     with the time per mel row
     the attention microbenchmark variants (attention_variants.cu: v2, RoPE
     (a rotation kernel, then the v2 core), channel-major K, the three
     softmax decompositions) against their plain versions at (2, 97),
     (16, 1024) and the tools' (64, 1000), f32 and bf16, beside one
     scaled_dot_product_attention call where one computes the same function,
     with the device ms of a call by kernel (torch.profiler) for #7 and the
     f32 variants; the rotation alone against its plain version, bit for
     bit; the three adapters onto the packed kernels;
     then the port's attention tools (stabletts_torch/tools/attn_bench.py and
     attn_exp.py) at (64, 1000) bf16 with the launches of each kernel
  4. serving: StableTTSAPI at the flagship config (random weights from a
     numpy seed, adaLN randomised): English requests, one batch request and
     a bf16 synthesise + Vocos batch at the bench shape (B=8, 1000 frames),
     with the launch counts of each kernel on that path; then the same
     request under each block configuration (the STABLETTS_* variables: two
     kernels, composed attention in both layouts and through the flash
     adapter, the all-library block), each against the default's mel with
     its exact launch counts, and the bench batch under two of them; one
     request per ODE solver with its estimator calls; one request through
     the FireflyGAN vocoder, and that vocoder on the GPU against the CPU;
     one request each in Japanese, Chinese (from pinned phoneme ids: the
     machine with the card has no jieba) and mixed ja+en text
     (`serving_languages`); a reference clip written as WAV and FLAC (and mp3
     and ogg where their codec libraries are here), each reference mel held
     to the WAV's, and a request from each compressed file
     (`serving_ref_formats`); the port's serving bench at its defaults (B=192,
     1000 frames, CFG 1, bf16; CFG 3 at B=96; the B=1 latency) behind its
     kernel gate, its JSON line and then the `bench` record
  5. device time by kernel over one request (torch.profiler)
  6. one request on the GPU (kernels) against the same request on the CPU
     (plain versions), same weights and noise
  7. training: `train()` at the flagship config on a synthetic filelist
     (B=32, mels of 901-1000 frames, text padded to 512), 2 epochs then a
     resume, with the launches of each training kernel per step; 8 steps
     overfitting one batch; device time by kernel over one step, f32 and
     bf16; one step at
     B=2 on the GPU against the CPU path, same weights and draws, and the
     same step in bf16 against f32 on the GPU (`train_bf16_vs_f32`)
  8. the opt-in training kernels against their plain versions (packed
     attention with dropout beside one scaled_dot_product_attention call,
     forward and backward; the mu prenet; the MPD period stack, five
     periods), then `train_config`: one trainer batch under each training
     configuration (the STABLETTS_ATTN_TRAIN / STABLETTS_PRENET_TRAIN
     variables) with its exact launch counts, its losses and gradients
     against the default's with dropout off, wall ms and peak memory; and
     `train_bf16`: `train()` with compute_dtype="bfloat16", then two bf16
     steps under STABLETTS_ATTN_TRAIN=xla (packed attention's bf16 kernels)
  9. Vocos GAN training: `train_vocos()` at the flagship Vocos on WAV files
     written from a seed (B=16, segment 20480, f32), a checkpoint and a
     resume; one bf16 step; device time by kernel over one step; `mpd_stack`
     on the trainer's folded MPD weights and a real and a generated batch
     against the trainer's `DiscriminatorP`; one step on the GPU against the
     CPU from the same state
 10. the `kernels` line (launches: over the main paths' runs, the
     `inference`, language and reference-format requests and the bench's
     timed iterations of phase 4, the requests of phase 4's block
     configurations that run the kernel, the `train_steps` run of phase 7,
     the `train_config` runs that run the kernel and the `mpd_in_gan` run;
     times: the bf16 bench shape for serving kernels; the decoder's shape in
     the trainer, f32 at B=32, T=1000, dropout 0.1, for the training kernels,
     and the same shape in bf16 for the training attention core ("_bf16",
     launches from the bf16 training runs);
     [32, 1000, 512] for MAS; [16, 20480], period 2, for the MPD stack;
     the attention tools' (64, 1000) bf16 for the attention variants, whose
     launches are those of the two tools' runs); then
     the card line and the result line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense, no tensor-core f32
PEAK_BYTES = 3.35e12
try:  # every kernel's bar, shared with the serving bench's gate (stabletts_torch/tools/selftest.py)
    from stabletts_torch.ops.bars import BARS, VARIANT_KERNELS
except ImportError:  # outside the repository: main() says so and exits non-zero
    BARS, VARIANT_KERNELS = {}, ()
MPD_BAR = 2e-4  # max-abs, f32 (tests/test_mpd_pallas.py:29)
# shapes and lengths that run each form of the MAS kernel (b, Ty, Tx, t_ys, t_xs)
MAS_FORMS = [(4, 1000, 1024, [1000, 1000, 950, 300], [1024, 900, 1, 1000]),
             (2, 2000, 1024, [2000, 2000], [1024, 1]),
             (2, 300, 5000, [300, 300], [4200, 290]),
             (4, 301, 77, [301, 250, 77, 30], [77, 61, 77, 50])]
# the kernels built on csrc/attention.cuh's core: bf16 runs it on wgmma, f32 on FMA
ATTENTION_CORE_KERNELS = ("dit_block", "dit_attention", "attention_packed", "attention_packed_t", *VARIANT_KERNELS)
# the libraries that instantiate that core
ATTENTION_LIBS = ("attention_packed", "attention_variants", "dit_attention", "dit_block")
# the kernels built on csrc/attention_train.cuh's training core (bf16 on wgmma, f32 on FMA), its libraries and the
# three kernels of its bf16 form
TRAIN_CORE_KERNELS = ("attention_train_fwd", "attention_train_bwd", "dit_attention_train_fwd", "dit_attention_train_bwd")
TRAIN_CORE_LIBS = ("attention_train", "dit_attention_train")
TRAIN_CORE_FUNCTIONS = ("attn_fwd_kernel", "attn_bwd_dkv_kernel", "attn_bwd_dq_kernel")
# kernels whose products include common.cuh's tap GEMM (bf16 on wgmma, f32 on FMA): beside an attention core
# (the projections and convs of the DiT kernels), or as all of their products (ConvNeXt in both types since its f32
# route moved onto the f32 tap GEMM)
TAP_GEMM_PROJECTIONS = ("dit_block", "dit_attention", "dit_attention_train_fwd", "dit_attention_train_bwd")
TAP_GEMM_KERNELS = ("adaln_ffn", "istft", "ffn_train_fwd", "ffn_train_bwd", "prenet_train_fwd", "prenet_train_bwd",
                    "convnext", "tap_gemm", "wgrad")
# kernels whose weight gradients are common.cuh's launch_wgrad (bf16 on wgmma, f32 on the FMA wgrad_kernel): the
# three backwards and the bare entry; and the libraries that instantiate its bf16 form
WGRAD_KERNELS = ("dit_attention_train_bwd", "ffn_train_bwd", "prenet_train_bwd", "wgrad")
WGRAD_LIBS = ("dit_attention_train", "ffn_train", "prenet_train", "wgrad")
# kernels with no product at all
NO_PRODUCT_KERNELS = ("colsum", "rope_packed")
# the libraries that instantiate the bf16 tap GEMM
TAP_GEMM_LIBS = ("adaln_ffn", "convnext", "dit_attention", "dit_attention_train", "dit_block", "ffn_train", "istft",
                 "prenet_train", "tap_gemm")
KERNEL_INFO = {
    "dit_block": ("stabletts_torch/csrc/dit_block.cu", "stabletts_tpu/ops/dit_block_pallas.py:98"),
    "dit_attention": ("stabletts_torch/csrc/dit_attention.cu", "stabletts_tpu/ops/dit_attention_pallas.py:122"),
    "adaln_ffn": ("stabletts_torch/csrc/adaln_ffn.cu", "stabletts_tpu/ops/ffn_pallas.py:74"),
    "attention_packed": ("stabletts_torch/csrc/attention_packed.cu", "stabletts_tpu/ops/attention_pallas.py:67"),
    "attention_packed_t": ("stabletts_torch/csrc/attention_packed.cu", "stabletts_tpu/ops/attention_pallas_t.py:64"),
    "convnext": ("stabletts_torch/csrc/convnext.cu", "stabletts_tpu/ops/convnext_pallas.py:84"),
    "istft": ("stabletts_torch/csrc/istft.cu", "stabletts_tpu/ops/istft_pallas.py:55"),
    "dit_attention_train_fwd": ("stabletts_torch/csrc/dit_attention_train.cu",
                                "stabletts_tpu/ops/dit_attention_pallas_train.py:273"),
    "dit_attention_train_bwd": ("stabletts_torch/csrc/dit_attention_train.cu",
                                "stabletts_tpu/ops/dit_attention_pallas_train.py:302"),
    "ffn_train_fwd": ("stabletts_torch/csrc/ffn_train.cu", "stabletts_tpu/ops/ffn_pallas_train.py:189"),
    "ffn_train_bwd": ("stabletts_torch/csrc/ffn_train.cu", "stabletts_tpu/ops/ffn_pallas_train.py:218"),
    "mas": ("stabletts_torch/csrc/mas.cu", "stabletts_tpu/ops/mas_pallas.py:174"),
    "attention_train_fwd": ("stabletts_torch/csrc/attention_train.cu",
                            "stabletts_tpu/ops/attention_pallas_train.py:167"),
    "attention_train_bwd": ("stabletts_torch/csrc/attention_train.cu",
                            "stabletts_tpu/ops/attention_pallas_train.py:191"),
    # the bf16 form of the training attention core (wgmma), at the same shapes
    "dit_attention_train_fwd_bf16": ("stabletts_torch/csrc/attention_train.cuh",
                                     "stabletts_tpu/ops/dit_attention_pallas_train.py:273"),
    "dit_attention_train_bwd_bf16": ("stabletts_torch/csrc/attention_train.cuh",
                                     "stabletts_tpu/ops/dit_attention_pallas_train.py:302"),
    "attention_train_fwd_bf16": ("stabletts_torch/csrc/attention_train.cuh",
                                 "stabletts_tpu/ops/attention_pallas_train.py:167"),
    "attention_train_bwd_bf16": ("stabletts_torch/csrc/attention_train.cuh",
                                 "stabletts_tpu/ops/attention_pallas_train.py:191"),
    "prenet_train_fwd": ("stabletts_torch/csrc/prenet_train.cu", "stabletts_tpu/ops/prenet_pallas_train.py:119"),
    "prenet_train_bwd": ("stabletts_torch/csrc/prenet_train.cu", "stabletts_tpu/ops/prenet_pallas_train.py:145"),
    "mpd_stack": ("stabletts_torch/csrc/mpd_stack.cu", "stabletts_tpu/ops/mpd_pallas.py:227"),
    "attention_packed_v2": ("stabletts_torch/csrc/attention_variants.cu",
                            "stabletts_tpu/ops/attention_pallas_v2.py:67"),
    "attention_packed_rope": ("stabletts_torch/csrc/attention_variants.cu",
                              "stabletts_tpu/ops/attention_pallas.py:220"),
    # #7's rotation of q and k, which the TPU kernel runs inside each grid cell (_attn_rope_kernel)
    "rope_packed": ("stabletts_torch/csrc/attention_variants.cu", "stabletts_tpu/ops/attention_pallas.py:165"),
    "attention_packed_kt": ("stabletts_torch/csrc/attention_variants.cu", "tools/attn_exp4.py:71"),
    "attention_decompose_matmul": ("stabletts_torch/csrc/attention_variants.cu", "tools/attn_exp2.py:104"),
    "attention_decompose_nomax": ("stabletts_torch/csrc/attention_variants.cu", "tools/attn_exp2.py:104"),
    "attention_decompose_bf16": ("stabletts_torch/csrc/attention_variants.cu", "tools/attn_exp2.py:104"),
}
# the experiments that run as adapters onto a kernel of the line, by that kernel
ADAPTERS = {"attention_packed_v2": [("attention_head_pair", "tools/attn_exp.py:94"),
                                    ("attention_flash_chunks", "tools/attn_exp3.py:86")],
            "attention_packed": [("attention_batch_pair", "tools/attn_exp5.py:103")]}
TRAIN_LAUNCHES_PER_STEP = {"dit_attention_train_fwd": 9, "dit_attention_train_bwd": 9, "ffn_train_fwd": 9,
                           "ffn_train_bwd": 9, "mas": 1}
DT_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# kernel-name parts whose device time the profile phases sum: the weight-gradient GEMM (wgmma, FMA) and the sum of its
# row chunks, the column sums (one pass or two), the tap GEMM (wgmma, FMA), the training attention core's three
# kernels (each name part covers its f32 and its bf16 form) and its row sums D, the f32 serving attention core (every
# option), ConvNeXt's depthwise conv + LayerNorm, MAS's two kernels and #7's rotation
PROFILE_FAMILIES = ("wgrad_wgmma_kernel", "wgrad_f32_kernel", "sum_splits_kernel", "colsum", "tap_gemm_wgmma_kernel",
                    "tap_gemm_f32_kernel", "attn_fwd_kernel", "attn_bwd_dkv_kernel", "attn_bwd_dq_kernel",
                    "rowdot_kernel", "attention_kernel_f32", "dwconv_ln_kernel", "mas_kernel",
                    "mas_path_kernel", "rope_packed_kernel")
# the FMA (f32) forms of common.cuh's tap GEMM and weight gradient, of attention_train.cuh's training core and of
# attention.cuh's serving core (under every option), convnext.cu's depthwise conv + LayerNorm and #7's rotation (both
# types), whose registers and spills the `ptxas` line reports
F32_GEMM_FUNCTIONS = ("tap_gemm_f32_kernel", "wgrad_f32_kernel")
F32_TRAIN_CORE_FUNCTIONS = ("attn_fwd_kernel_f32", "attn_bwd_dkv_kernel_f32", "attn_bwd_dq_kernel_f32")
F32_SERVING_FUNCTIONS = ("attention_kernel_f32", "dwconv_ln_kernel", "rope_packed_kernel")
# MAS (mas_kernel<cells a lane, ring slots, bits in shared memory> and mas_path_kernel) and the MPD stack's
# conv_post; the MPD stack's tap GEMMs are listed under their own key ("... in mpd_stack")
MAS_MPD_FUNCTIONS = ("mas_kernel", "mas_path_kernel", "conv_post_kernel")


# attention.cuh's MODE values, by number
SOFTMAX_MODES = ("SM_ONLINE", "SM_NOMAX", "SM_SCORE_LOWP", "SM_NONE")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def with_core(row: dict) -> dict:
    """The row with the unit its products run on: "core" is "wgmma" for a
    bf16 kernel on attention.cuh's or attention_train.cuh's core or whose
    products are all tap GEMMs or weight-gradient GEMMs, else "fma" (every
    f32 product is fp32 FMA; "none" for the column sums, which have no
    product); "projections" names the unit of the tap GEMMs beside an
    attention core, and "wgrad" that of a backward's weight-gradient GEMM
    (wgmma in bf16, FMA in f32)."""
    kernel, bf16 = row.get("kernel"), row.get("dtype") == "bfloat16"
    wgmma = bf16 and kernel in (*ATTENTION_CORE_KERNELS, *TRAIN_CORE_KERNELS, *TAP_GEMM_KERNELS)
    row["core"] = "none" if kernel in NO_PRODUCT_KERNELS else ("wgmma" if wgmma else "fma")
    if kernel in TAP_GEMM_PROJECTIONS:
        row["projections"] = "wgmma" if bf16 else "fma"
    if kernel in WGRAD_KERNELS:
        row["wgrad"] = "wgmma" if bf16 else "fma"
    return row


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        return math.inf, math.inf
    abs_err = (got - ref).abs().max().item()
    return abs_err / max(ref.abs().max().item(), 1e-30), abs_err


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- kernels --


def phase_sass() -> None:
    """The HGMMA (wgmma) instructions in each built library's SASS
    (cuobjdump -sass), in total and in each function of attention.cuh's bf16
    core (`attention_kernel_wgmma`), of attention_train.cuh's
    (`attn_fwd_kernel_wgmma`, `attn_bwd_dkv_kernel_wgmma`,
    `attn_bwd_dq_kernel_wgmma`), of common.cuh's bf16 tap GEMM
    (`tap_gemm_wgmma_kernel`, one function per epilogue) and of its bf16
    weight-gradient GEMM (`wgrad_wgmma_kernel`). Fails if a library that
    instantiates a core, the bf16 tap GEMM or the bf16 weight gradient lacks
    its wgmma functions, if one of them has no HGMMA, or if any library holds
    an FMA kernel (one of the three FMA training kernels, `tap_gemm_kernel`
    or `wgrad_kernel`) for bf16. The serving core's FMA kernel,
    `attention_kernel_f32`, takes f32 alone."""
    import re
    import shutil

    from stabletts_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    libs, bad = {}, []
    for name in sorted(_build._libs):
        sass = subprocess.run([tool, "-sass", os.path.join(_build.BUILD_DIR, f"lib{name}.so")], capture_output=True,
                              text=True, check=False).stdout
        fn, per_fn, total = None, {}, 0
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                per_fn.setdefault(fn, 0)
            elif "HGMMA" in line:
                total += 1
                if fn is not None:
                    per_fn[fn] += 1
        core = {f: n for f, n in per_fn.items() if "attention_kernel_wgmma" in f}
        train = {k: n for k in TRAIN_CORE_FUNCTIONS for f, n in per_fn.items() if f"{k}_wgmma" in f}
        train_fma_bf16 = [f for f in per_fn for k in TRAIN_CORE_FUNCTIONS if f"{k}I13__nv_bfloat16" in f]
        tap = {f: n for f, n in per_fn.items() if "tap_gemm_wgmma_kernel" in f}
        tap_fma_bf16 = [f for f in per_fn if "tap_gemm_kernelI13__nv_bfloat16" in f]
        wgrad = {f: n for f, n in per_fn.items() if "wgrad_wgmma_kernel" in f}
        wgrad_fma_bf16 = [f for f in per_fn if "wgrad_kernelI13__nv_bfloat16" in f]
        libs[name] = {"hgmma": total, "wgmma_attention_functions": len(core),
                      "hgmma_per_attention_function": sorted(set(core.values())),
                      "hgmma_per_training_attention_function": train,
                      "fma_bf16_training_attention_functions": len(train_fma_bf16),
                      "wgmma_tap_gemm_functions": len(tap), "hgmma_per_tap_gemm_function": sorted(set(tap.values())),
                      "fma_bf16_tap_gemm_functions": len(tap_fma_bf16),
                      "wgmma_wgrad_functions": len(wgrad), "hgmma_per_wgrad_function": sorted(set(wgrad.values())),
                      "fma_bf16_wgrad_functions": len(wgrad_fma_bf16)}
        if ((name in ATTENTION_LIBS and not core) or any(n == 0 for n in core.values())
                or (name in TRAIN_CORE_LIBS and len(train) != len(TRAIN_CORE_FUNCTIONS))
                or any(n == 0 for n in train.values()) or train_fma_bf16
                or (name in TAP_GEMM_LIBS and not tap) or any(n == 0 for n in tap.values()) or tap_fma_bf16
                or (name in WGRAD_LIBS and not wgrad) or any(n == 0 for n in wgrad.values()) or wgrad_fma_bf16):
            bad.append(name)
    ok = not bad and all(name in libs for name in (*ATTENTION_LIBS, *TRAIN_CORE_LIBS, *TAP_GEMM_LIBS, *WGRAD_LIBS))
    emit({"phase": "sass", "tool": tool, "libraries": libs, "ok": ok})
    if not ok:
        fail(f"sass: libraries without wgmma in a bf16 attention core, tap GEMM or weight gradient, or with an FMA one "
             f"in bf16: {bad}")


def phase_ptxas() -> None:
    """Registers and spill bytes of the f32 tap GEMM and weight gradient
    (F32_GEMM_FUNCTIONS), of the f32 training attention core
    (F32_TRAIN_CORE_FUNCTIONS) and of the f32 serving core under each
    option, ConvNeXt's depthwise conv + LayerNorm and #7's rotation
    (F32_SERVING_FUNCTIONS, both types of the latter two), and of MAS and the MPD stack (MAS_MPD_FUNCTIONS, and the f32 tap
    GEMMs of the mpd_stack library under keys of their own), read from the
    `-Xptxas -v` report that the build keeps beside each library: per kernel
    and template (tile, w_trans; for MAS cells a lane, ring slots, where the
    bits go) the count of instantiations over all libraries, their least and
    most registers, and each instantiation that spills."""
    import re

    from stabletts_torch.ops import _build

    kernels = {}
    for name in sorted(_build._libs):
        path = os.path.join(_build.BUILD_DIR, f"{name}.log")
        if not os.path.exists(path):
            continue
        row = None
        with open(path) as f:
            for line in f:
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    fn = m.group(1)
                    kind = next((k for k in (*F32_GEMM_FUNCTIONS, *F32_TRAIN_CORE_FUNCTIONS, *F32_SERVING_FUNCTIONS,
                                             *MAS_MPD_FUNCTIONS) if k in fn), None)
                    row = None
                    if kind:
                        # tap_gemm_f32_kernel<BM, BN, WT, Epi> mangles as ...ILi128ELi128ELb1E<Epi>...,
                        # attention_kernel_f32<TMINOR, BQ, QPRE, KTMINOR, MODE, PAD_ZERO> as
                        # ...ILb0ELi64ELb1ELb0ELi0ELb0E..., dwconv_ln_kernel<T, CW> as ...IfLi16E...
                        t = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", fn)
                        a = re.search(r"attention_kernel_f32ILb([01])ELi(\d+)ELb([01])ELb([01])ELi(\d)ELb([01])E", fn)
                        if kind == "mas_kernel":
                            key = (f"{kind}<{t.group(1)}, {t.group(2)}, "
                                   f"{'shared' if t.group(3) == '1' else 'workspace'}>")
                        elif kind in ("mas_path_kernel", "conv_post_kernel"):
                            key = kind
                        elif t:
                            key = f"{kind}<{t.group(1)}, {t.group(2)}, {'true' if t.group(3) == '1' else 'false'}>"
                        elif a:
                            tf = ["false", "true"]
                            key = (f"{kind}<{tf[int(a.group(1))]}, {a.group(2)}, {tf[int(a.group(3))]}, "
                                   f"{tf[int(a.group(4))]}, {SOFTMAX_MODES[int(a.group(5))]}, {tf[int(a.group(6))]}>")
                        elif kind in ("dwconv_ln_kernel", "rope_packed_kernel"):
                            key = f"{kind}<{'float' if f'{kind}If' in fn else 'bf16'}>"
                        else:
                            key = kind if kind in F32_TRAIN_CORE_FUNCTIONS else f"{kind}<float>"
                        if name == "mpd_stack" and kind in F32_GEMM_FUNCTIONS:
                            key += " in mpd_stack"
                        row = {"key": key, "library": name, "function": fn}
                        kernels.setdefault(key, []).append(row)
                    continue
                if row is None:
                    continue
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    row.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    row["registers"] = int(m.group(1))
    summary = {}
    for key, rows in sorted(kernels.items()):
        regs = [r.get("registers", 0) for r in rows]
        summary[key] = {"instantiations": len(rows), "registers": [min(regs), max(regs)],
                        "spilling": [{"library": r["library"], "function": r["function"],
                                      "spill_stores": r.get("spill_stores"), "spill_loads": r.get("spill_loads")}
                                     for r in rows if r.get("spill_stores") or r.get("spill_loads")]}
    emit({"phase": "ptxas", "kernels": summary})


def measure(kernel: str, dtype, shape: dict, run, run_plain, flops: float, io_bytes: float, select=None,
            library=None) -> dict:
    """One kernel case: error against the plain version on the same inputs
    (on `select`'s part of the outputs, the rest held to be finite), median
    times of both, the bound of the work, and the time of `library`, one
    PyTorch call that computes the same function (a yardstick only)."""
    got, want = run(), run_plain()
    finite = bool(torch.isfinite(got).all())
    if select is not None:
        got, want = select(got), select(want)
    rel, ab = rel_err(got, want)
    bar = BARS[kernel][dtype]
    bound, bound_by = bound_ms(flops, io_bytes, dtype)
    return {"kernel": kernel, "dtype": DT_NAME[dtype], **shape, "rel_err": rel, "max_abs_err": ab,
            "bar": bar, "ok": finite and rel <= bar, "ms": time_ms(run), "plain_ms": time_ms(run_plain, iters=5),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None if library is None else time_ms(library)}


def _ragged_mask(b, t, dev):
    lengths = torch.tensor([t - (i * 37) % max(1, t // 2) for i in range(b)], device=dev)
    return (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()


# a request's mask: a 313-frame sentence in the 1024-frame mel cap, both CFG halves
REQUEST_LEN = 313


def _mask(kind, b, t, dev):
    """[B, T] key mask of one kind: "ragged" (_ragged_mask), "request" (every
    item REQUEST_LEN long), "all_masked" (item 0 has no valid key, the rest
    ragged) or "holed" (item 0 loses keys 320-383, one whole 64-key tile in
    the middle; the rest ragged)."""
    if kind == "request":
        return (torch.arange(t, device=dev)[None, :] < REQUEST_LEN).float().repeat(b, 1)
    mask = _ragged_mask(b, t, dev)
    if kind == "all_masked":
        mask[0] = 0.0
    elif kind == "holed":
        mask[0, 320:384] = 0.0
    return mask


def _valid(mask, b, t) -> torch.Tensor:
    """Rows (queries, and keys) each item needs: its valid ones, all T where it has none
    (its output is then uniform over every key and is held to the plain version's)."""
    if mask is None:
        return torch.full((b,), float(t))
    n = (mask > 0).sum(1).float().cpu()
    return torch.where(n > 0, n, torch.full_like(n, float(t)))


def _shape(b, t, kind) -> dict:
    return {"B": b, "T": t, **({} if kind == "ragged" else {"mask": kind})}


def check_dit(rng, b, t, dtype, dev, mask_kind="ragged"):
    """The whole DiT block against its plain version on every row (padded rows
    are masked in both). The bound counts the work of the valid rows: the
    projections and convs of each item's valid rows, its attention's valid
    queries x valid keys."""
    from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, dit_block_plain

    c, f, heads = 256, 1024, 4
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    w = DiTWeights(g(c, 3 * c, scale=c ** -0.5), g(3 * c, scale=0.02), g(c, c, scale=c ** -0.5),
                   g(c, scale=0.02), g(3, c, f, scale=(3 * c) ** -0.5), g(f, scale=0.02),
                   g(3, f, c, scale=(3 * f) ** -0.5), g(c, scale=0.02))
    mask = _mask(mask_kind, b, t, dev)
    x = g(b, t, c) * mask[..., None].to(dtype)
    mods = g(b, 6, c, scale=0.1)
    n = _valid(mask, b, t)
    flops = float(2 * n.sum() * c * 4 * c + 4 * heads * (n * n).sum() * (c // heads) + 4 * n.sum() * 3 * c * f)
    return measure("dit_block", dtype, _shape(b, t, mask_kind), lambda: dit_block(x, mods, mask, w, heads),
                   lambda: dit_block_plain(x, mods, mask, w, heads), flops, nbytes(x, mods, mask, *w, x))


def check_dit_attention(rng, b, t, dtype, dev):
    from stabletts_torch.ops.dit_attention_cuda import dit_attention, dit_attention_plain

    c, heads = 256, 4
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    w = [g(c, 3 * c, scale=c ** -0.5), g(3 * c, scale=0.02), g(c, c, scale=c ** -0.5), g(c, scale=0.02)]
    mask = _ragged_mask(b, t, dev)
    x = g(b, t, c) * mask[..., None].to(dtype)
    mods = g(b, 3, c, scale=0.1)
    n = _valid(mask, b, t)
    flops = float(2 * n.sum() * c * 4 * c + 4 * heads * (n * n).sum() * (c // heads))
    return measure("dit_attention", dtype, {"B": b, "T": t}, lambda: dit_attention(x, mods, mask, *w, heads),
                   lambda: dit_attention_plain(x, mods, mask, *w, heads), flops, nbytes(x, mods, mask, *w, x))


def check_adaln_ffn(rng, b, t, dtype, dev):
    from stabletts_torch.ops.adaln_ffn_cuda import adaln_ffn, adaln_ffn_plain

    c, f = 256, 1024
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    w = [g(3, c, f, scale=(3 * c) ** -0.5), g(f, scale=0.02), g(3, f, c, scale=(3 * f) ** -0.5), g(c, scale=0.02)]
    mask = _ragged_mask(b, t, dev)
    x = g(b, t, c) * mask[..., None].to(dtype)
    mods = g(b, 3, c, scale=0.1)
    flops = float(4 * _valid(mask, b, t).sum() * 3 * c * f)
    return measure("adaln_ffn", dtype, {"B": b, "T": t}, lambda: adaln_ffn(x, mods, mask, *w),
                   lambda: adaln_ffn_plain(x, mods, mask, *w), flops, nbytes(x, mods, mask, *w, x))


def check_attention_packed(rng, b, t, dtype, dev, masked, tminor, mask_kind="ragged"):
    """Packed-head attention ([B, T, C], or channel-major [B, C, T] with
    tminor) against its plain version on the valid query rows and on every
    row of an item with no valid key; other padded rows must be finite. The
    bound counts each item's valid queries x valid keys (T x T for an item
    with none). The library yardstick is one scaled_dot_product_attention
    call with the same key mask, with the layout changes it needs from and to
    the kernel's layout counted."""
    import torch.nn.functional as F

    from stabletts_torch.ops import attention_packed_cuda as ap

    c, heads, d = 256, 4, 64
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q, k, v = g(b, t, c), g(b, t, c), g(b, t, c)
    mask = _mask(mask_kind, b, t, dev) if masked else None
    rows = torch.ones(b, t, dtype=torch.bool, device=dev) if mask is None else (mask > 0) | (mask.amax(1) <= 0)[:, None]
    key_mask = None if mask is None else (mask > 0)[:, None, None, :]
    if tminor:
        q, k, v = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        fn, plain, name = ap.attention_packed_t, ap.attention_packed_t_plain, "attention_packed_t"
        select = lambda o: o.transpose(1, 2)[rows]
        to_bhtd = lambda a: a.view(b, heads, d, t).transpose(2, 3)
        from_bhtd = lambda o: o.transpose(2, 3).reshape(b, c, t)
    else:
        fn, plain, name = ap.attention_packed, ap.attention_packed_plain, "attention_packed"
        select = lambda o: o[rows]
        to_bhtd = lambda a: a.view(b, t, heads, d).transpose(1, 2)
        from_bhtd = lambda o: o.transpose(1, 2).reshape(b, t, c)
    library = lambda: from_bhtd(F.scaled_dot_product_attention(to_bhtd(q), to_bhtd(k), to_bhtd(v),
                                                               attn_mask=key_mask))
    n = _valid(mask, b, t)
    row = measure(name, dtype, {**_shape(b, t, mask_kind), "masked": masked}, lambda: fn(q, k, v, mask, n_heads=heads),
                  lambda: plain(q, k, v, mask, n_heads=heads), float(4 * heads * (n * n).sum() * d),
                  nbytes(q, k, v, q) + (0 if mask is None else nbytes(mask)), select=select, library=library)
    row["library_rel_err"] = rel_err(select(library()), select(plain(q, k, v, mask, n_heads=heads)))[0]
    return row


def check_flash_adapter(rng, b, t, dev) -> dict:
    """`masked_attention(impl="flash")`, the adapter onto the packed-head
    kernel, against the plain `xla` path after masking the padded rows."""
    from stabletts_torch.ops.attention import masked_attention
    from stabletts_torch.ops.attention_packed_cuda import attention_packed

    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    q, k, v = g(b, t, 4, 64), g(b, t, 4, 64), g(b, t, 4, 64)
    mask = _ragged_mask(b, t, dev)
    before = attention_packed.launches
    got = masked_attention(q, k, v, mask=mask, impl="flash") * mask[:, :, None, None]
    launched = attention_packed.launches - before
    want = masked_attention(q, k, v, mask=mask, impl="xla") * mask[:, :, None, None]
    rel, ab = rel_err(got, want)
    return {"kernel": "flash_adapter", "dtype": "float32", "B": b, "T": t, "rel_err": rel, "max_abs_err": ab,
            "bar": 5e-3, "launches_of_attention_packed": launched, "ok": rel <= 5e-3 and launched == 1}


def check_convnext(rng, b, t, dtype, dev):
    from stabletts_torch.ops.convnext_cuda import ConvNeXtWeights, convnext_block, convnext_block_plain

    c, f = 512, 1536
    g = lambda *s, scale=1.0, off=0.0: torch.from_numpy(
        (rng.standard_normal(s) * scale + off).astype(np.float32)).to(dev, dtype)
    w = ConvNeXtWeights(g(7, c, scale=7 ** -0.5), g(c, scale=0.02), g(c, scale=0.1, off=1.0), g(c, scale=0.02),
                        g(c, f, scale=c ** -0.5), g(f, scale=0.02), g(f, c, scale=f ** -0.5), g(c, scale=0.02),
                        g(c, scale=0.05, off=1.0 / 8))
    x = g(b, t, c)
    return measure("convnext", dtype, {"B": b, "T": t}, lambda: convnext_block(x, w),
                   lambda: convnext_block_plain(x, w), 4 * b * t * c * f + 14 * b * t * c, nbytes(x, *w, x))


def check_istft(rng, b, t, dtype, dev, with_lengths=False):
    from stabletts_torch.ops.istft import idft_matrix_windowed
    from stabletts_torch.ops.istft_cuda import istft_head

    n_fft, hop = 2048, 512
    nf = n_fft // 2 + 1
    mag = np.exp(np.clip(rng.standard_normal((b, t, nf)), None, math.log(100.0)))
    phase = rng.uniform(-np.pi, np.pi, (b, t, nf))
    re = torch.from_numpy((mag * np.cos(phase)).astype(np.float32)).to(dev)
    im = torch.from_numpy((mag * np.sin(phase)).astype(np.float32)).to(dev)
    lengths = None
    if with_lengths:
        lengths = torch.tensor([t - (i * 53) % max(1, t // 2) for i in range(b)], device=dev)
    md = None if dtype == torch.float32 else dtype
    w = idft_matrix_windowed(n_fft, n_fft, dev, dtype)
    io = 2 * b * t * nf * w.element_size() + nbytes(w) + b * t * hop * 4
    return measure("istft", dtype, {"B": b, "T": t, "lengths": with_lengths},
                   lambda: istft_head(re, im, n_fft, hop, md, lengths),
                   lambda: _istft_plain_on(re, im, n_fft, hop, md, lengths), 2 * b * t * (n_fft + 2) * n_fft, io)


# the tap GEMM's products on the bench batch's DiT block: (taps, K, N)
TAP_GEMM_SHAPES = {"qkv": (1, 256, 768), "out_proj": (1, 256, 256), "conv1": (3, 256, 1024), "conv2": (3, 1024, 256)}


def check_tap_gemm(rng, b, t, dtype, dev, product):
    """The bare tap GEMM (csrc/tap_gemm.cu, plain store epilogue) at one of
    the DiT block's products, a "same" conv along T for 3 taps, against
    `tap_gemm_plain`; the library yardstick is one torch.matmul (1 tap) or
    F.conv1d (3 taps) call in the same dtype."""
    import torch.nn.functional as F

    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm, tap_gemm_plain, tap_gemm_tile

    taps, k, n = TAP_GEMM_SHAPES[product]
    a = torch.from_numpy(rng.standard_normal((b * t, k)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((taps, k, n)) * (taps * k) ** -0.5).astype(np.float32)).to(dev, dtype)
    kw = dict(t_in=t, t_out=t, taps=taps, shift0=-(taps // 2), shift_step=1)
    if taps == 1:
        library = lambda: torch.matmul(a, w[0])
    else:
        x, wc = a.view(b, t, k).transpose(1, 2), w.permute(2, 1, 0).contiguous()
        library = lambda: F.conv1d(x, wc, padding=taps // 2)
    row = measure("tap_gemm", dtype, {"B": b, "T": t, "product": product, "taps": taps, "K": k, "N": n},
                  lambda: tap_gemm(a, w, **kw), lambda: tap_gemm_plain(a, w, **kw), 2 * b * t * k * n * taps,
                  nbytes(a, w) + b * t * n * a.element_size(), library=library)
    row["tile"] = tap_gemm_tile(b * t, n, dtype)
    return row


# the weight-gradient GEMM's products in a decoder layer of the training step: (taps, ka, n), as dWo, dWqkv
# (dit_attention_train.cu) and dW1, dW2 (ffn_train.cu)
WGRAD_SHAPES = {"out_proj": (1, 256, 256), "qkv": (1, 256, 768), "conv1": (3, 256, 1024), "conv2": (3, 1024, 256)}


def check_wgrad(rng, b, t, dtype, dev, product):
    """The bare weight-gradient GEMM (csrc/wgrad.cu) at one of a decoder
    layer's products, for 3 taps the weight gradient of a "same" conv along
    T, against `wgrad_plain`; two runs must give equal bits. The library
    yardstick is one call in the same dtype: `torch.matmul(a.T, g)` (1 tap)
    or cuDNN's wgrad, `aten.convolution_backward` with only the weight's
    gradient asked (3 taps; its [B, C, T] operands made beforehand)."""
    from stabletts_torch.ops.tap_gemm_cuda import wgrad, wgrad_plain, wgrad_tile

    taps, ka, n = WGRAD_SHAPES[product]
    a = torch.from_numpy(rng.standard_normal((b * t, ka)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.standard_normal((b * t, n)).astype(np.float32)).to(dev, dtype)
    kw = dict(t_len=t, taps=taps, shift0=-(taps // 2), shift_step=1 if taps > 1 else 0)
    if taps == 1:
        library = lambda: torch.matmul(a.t(), g)
    else:
        x = a.view(b, t, ka).transpose(1, 2).contiguous()
        gy = g.view(b, t, n).transpose(1, 2).contiguous()
        wc = torch.zeros(n, ka, taps, device=dev, dtype=dtype)  # only its shape is read
        library = lambda: torch.ops.aten.convolution_backward(gy, x, wc, None, [1], [taps // 2], [1], False, [0], 1,
                                                              [False, True, False])[1]
    row = measure("wgrad", dtype, {"B": b, "T": t, "product": product, "taps": taps, "ka": ka, "N": n},
                  lambda: wgrad(a, g, **kw), lambda: wgrad_plain(a, g, **kw), 2 * b * t * ka * n * taps,
                  nbytes(a, g) + taps * ka * n * 4, library=library)
    row["same_bits_twice"] = bool(torch.equal(wgrad(a, g, **kw), wgrad(a, g, **kw)))
    row["ok"] = row["ok"] and row["same_bits_twice"]
    row["tile"] = wgrad_tile(dtype)
    return row


def check_colsum(rng, b, t, dtype, dev, n, groups):
    """The bare column sums (csrc/wgrad.cu) of x [B * T, N] in `groups`
    groups of rows against `colsum_plain`; two runs must give equal bits. The
    library yardstick is one x.view(groups, rows, N).sum(1,
    dtype=torch.float32) call."""
    from stabletts_torch.ops.tap_gemm_cuda import colsum, colsum_plain

    rows = b * t // groups
    x = torch.from_numpy(rng.standard_normal((groups * rows, n)).astype(np.float32)).to(dev, dtype)
    row = measure("colsum", dtype, {"rows": rows, "N": n, "groups": groups}, lambda: colsum(x, groups),
                  lambda: colsum_plain(x, groups), groups * rows * n, nbytes(x) + groups * n * 4,
                  library=lambda: x.view(groups, rows, n).sum(1, dtype=torch.float32))
    row["same_bits_twice"] = bool(torch.equal(colsum(x, groups), colsum(x, groups)))
    row["ok"] = row["ok"] and row["same_bits_twice"]
    return row


def _istft_plain_on(re, im, n_fft, hop, md, lengths):
    from stabletts_torch.ops.istft import istft_same_real

    fm = None
    if lengths is not None:
        fm = (torch.arange(re.shape[1], device=re.device)[None, :] < lengths[:, None]).float()
    return istft_same_real(re, im, n_fft, hop, n_fft, md, fm)


def phase_kernels(dev) -> dict:
    """Every serving kernel against its plain version at the path's shapes,
    f32 and bf16, and the f32 serving attention core at the masks `_mask`
    names; returns the bench-shape rows (bf16; the DiT kernels and
    packed attention, with a mask, at 2B=16, T=1024; ConvNeXt/ISTFT at B=8,
    T=1000) keyed by kernel, for the kernels line."""
    rng = np.random.default_rng(1234)
    rows, bench_rows = [], {}
    f32, bf = torch.float32, torch.bfloat16
    cases = [(check_dit, dict(b=b, t=t, dtype=dt)) for b, t in ((2, 1024), (16, 1024), (2, 97)) for dt in (f32, bf)]
    halves = [(16, 1024, f32), (16, 1024, bf), (2, 1000, f32), (2, 97, f32), (2, 97, bf)]
    cases += [(fn, dict(b=b, t=t, dtype=dt)) for fn in (check_dit_attention, check_adaln_ffn) for b, t, dt in halves]
    cases += [(check_attention_packed, dict(b=b, t=t, dtype=dt, masked=masked, tminor=tminor))
              for tminor in (False, True) for b, t in ((16, 1024), (2, 1024), (2, 1000), (2, 97)) for dt in (f32, bf)
              for masked in (True, False)]
    # the f32 serving core at a request's mask (the key-tile skip and the zeroed padded query tiles), at an item
    # with no valid key (every tile runs) and at a mask with a hole of one whole key tile
    cases += [(check_dit, dict(b=2, t=1024, dtype=f32, mask_kind=kind)) for kind in ("request", "holed")]
    cases += [(check_attention_packed, dict(b=2, t=1024, dtype=f32, masked=True, tminor=tminor, mask_kind=kind))
              for tminor in (False, True) for kind in ("request", "all_masked", "holed")]
    cases += [(fn, dict(b=b, t=t, dtype=dt)) for fn in (check_convnext, check_istft)
              for b, t in ((1, 1000), (8, 1000), (1, 333)) for dt in (f32, bf)]
    cases.append((check_istft, dict(b=8, t=1000, dtype=f32, with_lengths=True)))
    # the serving bench's batch (stabletts_torch/tools/bench.py: B=192, 1000 frames, bf16; the DiT block at T=1024)
    cases += [(check_dit, dict(b=192, t=1024, dtype=bf)), (check_convnext, dict(b=192, t=1000, dtype=bf)),
              (check_istft, dict(b=192, t=1000, dtype=bf))]
    cases += [(check_tap_gemm, dict(b=16, t=1024, dtype=dt, product=p)) for p in TAP_GEMM_SHAPES for dt in (f32, bf)]
    # f32 also at a request's shape (2B = 2, the mel cap) and the training step's (B = 32, T = 1000)
    cases += [(check_tap_gemm, dict(b=b, t=t, dtype=f32, product=p)) for b, t in ((2, 1024), (32, 1000))
              for p in TAP_GEMM_SHAPES]
    cases += [(check_wgrad, dict(b=32, t=1000, dtype=dt, product=p)) for p in WGRAD_SHAPES for dt in (f32, bf)]
    cases += [(check_colsum, dict(b=32, t=1000, dtype=dt, n=n, groups=groups))
              for n, groups in ((256, 1), (1024, 1), (256, 32)) for dt in (f32, bf)]
    for fn, kw in cases:
        row = fn(rng, dev=dev, **kw)
        emit({"phase": "kernel_check", **with_core(row)})
        rows.append(row)
        at_bench = kw["b"] == (8 if fn in (check_convnext, check_istft) else 16) and kw["t"] >= 1000
        if (kw["dtype"] == bf and at_bench and kw.get("masked", True) and "mask_kind" not in kw
                and row["kernel"] not in ("tap_gemm", "wgrad", "colsum")):
            bench_rows[row["kernel"]] = row
    rows.append(check_flash_adapter(rng, 2, 1000, dev))
    emit({"phase": "kernel_check", **with_core(rows[-1])})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel check(s) over their bar: {bad}")
    return bench_rows


def check_attention_variant(rng, name, b, t, dtype, dev, masked) -> dict:
    """One kernel of attention_variants.cu against its plain version on the
    valid query rows (padded rows must be finite); the library yardstick is
    one scaled_dot_product_attention call with the same key mask where it
    computes the same function (v2, the channel-major K as a view, no copy,
    and the no-max softmax, which is the softmax). #7 and the f32 variants
    add one call's device ms, in all and by kernel (torch.profiler), and #7
    the bytes its rotation's round trip moves (q_r and k_r written and read
    again: the design's own cost beside the function's bound)."""
    import torch.nn.functional as F

    from stabletts_torch.ops import attention_variants_cuda as av
    from stabletts_torch.tools.device_time import device_ms

    c, heads, d = 256, 4, 64
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q, k, v = g(b, t, c), g(b, t, c), g(b, t, c)
    mask = _ragged_mask(b, t, dev) if masked else None
    rows = torch.ones(b, t, dtype=torch.bool, device=dev) if mask is None else mask > 0
    key_mask = None if mask is None else (mask > 0)[:, None, None, :]
    bhtd = lambda a: a.view(b, t, heads, d).transpose(1, 2)
    sdpa = lambda kh: F.scaled_dot_product_attention(bhtd(q), kh, bhtd(v), attn_mask=key_mask).transpose(1, 2)
    flops, library = 4 * b * heads * t * t * d, None
    if name == "attention_packed_v2":
        run, plain = (lambda: av.attention_packed_v2(q, k, v, mask)), (lambda: av.attention_packed_v2_plain(q, k, v, mask))
        library = lambda: sdpa(bhtd(k))
    elif name == "attention_packed_rope":
        run = lambda: av.attention_packed_rope(q, k, v, mask)
        plain = lambda: av.attention_packed_rope_plain(q, k, v, mask)
        flops += 6 * b * t * c  # x*cos + neg_half(x)*sin on q and k
    elif name == "attention_packed_kt":
        k = k.transpose(1, 2).contiguous()
        run, plain = (lambda: av.attention_packed_kt(q, k, v, mask)), (lambda: av.attention_packed_kt_plain(q, k, v, mask))
        library = lambda: sdpa(k.view(b, heads, d, t).transpose(2, 3))
    else:
        which = name.rsplit("_", 1)[1]
        run = lambda: av.attention_decompose(q, k, v, which)
        plain = lambda: av.attention_decompose_plain(q, k, v, which)
        if which == "nomax":
            library = lambda: sdpa(bhtd(k))
    row = measure(name, dtype, {"B": b, "T": t, "masked": masked}, run, plain, flops,
                  nbytes(q, k, v, q) + (0 if mask is None else nbytes(mask)), select=lambda o: o[rows],
                  library=None if library is None else lambda: library().reshape(b, t, c))
    if library is not None:
        row["library_rel_err"] = rel_err(library().reshape(b, t, c)[rows], plain()[rows])[0]
    if name == "attention_packed_rope":
        row["rotation_round_trip_bytes"] = 2 * nbytes(q, k)
    if name == "attention_packed_rope" or dtype == torch.float32:
        row["device_ms"], row["by_kernel"] = device_ms(run, calls=5)
    return row


def check_rope_packed(rng, b, t, dtype, dev) -> dict:
    """#7's rotation kernel alone against its plain version, bit for bit
    (both round each product and the sum to the dtype), with one call's
    device ms; bound by its bytes: q and k read, q_r and k_r written, the
    [T, C] cos/sin tables read once."""
    from stabletts_torch.ops import attention_variants_cuda as av
    from stabletts_torch.tools.device_time import device_ms

    c, heads, rot = 256, 4, 32
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q, k = g(b, t, c), g(b, t, c)
    run = lambda: av.rope_rotate_packed(q, k, heads, rot)
    plain = lambda: av.rope_rotate_packed_plain(q, k, heads, rot)
    got, want = torch.stack(run()), torch.stack(plain())
    rel, ab = rel_err(got, want)
    cos, sin = av.rope_packed_tables(t, heads, c // heads, rot, dtype, dev)
    # q pre-scaled, then x*cos, neg_half(x)*sin and their sum on q and k
    bound, bound_by = bound_ms(7 * b * t * c, 2 * nbytes(q, k) + nbytes(cos, sin), dtype)
    dev_ms, by_kernel = device_ms(run, calls=5)
    return {"kernel": "rope_packed", "dtype": DT_NAME[dtype], "B": b, "T": t, "masked": False, "rotary_dim": rot,
            "rel_err": rel, "max_abs_err": ab, "bar": BARS["rope_packed"][dtype],
            "ok": bool(torch.isfinite(got).all()) and rel <= BARS["rope_packed"][dtype], "ms": time_ms(run),
            "plain_ms": time_ms(plain, iters=5), "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "by_kernel": by_kernel}


def check_variant_adapters(rng, b, t, dev) -> list:
    """The three experiments that run as adapters (head pairs, key chunks,
    batch pairs) against the plain version of the function they compute,
    with one launch of the kernel they map onto."""
    from stabletts_torch.ops import attention_packed_cuda as ap
    from stabletts_torch.ops import attention_variants_cuda as av

    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    q, k, v = g(b, t, 256), g(b, t, 256), g(b, t, 256)
    mask = _ragged_mask(b, t, dev)
    kbias = torch.where(mask > 0, 0.0, -0.7 * torch.finfo(torch.float32).max)[:, None, :]
    rows, out = mask > 0, []
    for name, fn, want, kernel in (
            ("attention_head_pair", lambda: av.attention_head_pair(q, k, v), av.attention_packed_v2_plain(q, k, v),
             av.attention_packed_v2),
            ("attention_flash_chunks", lambda: av.attention_flash_chunks(q, k, v, mask),
             av.attention_packed_v2_plain(q, k, v, mask), av.attention_packed_v2),
            ("attention_batch_pair", lambda: av.attention_batch_pair(q, k, v, kbias),
             ap.attention_packed_plain(q, k, v, mask), ap.attention_packed)):
        before = kernel.launches
        got = fn()
        launched = kernel.launches - before
        rel, ab = rel_err(got[rows], want[rows])
        out.append({"kernel": name, "dtype": "float32", "B": b, "T": t, "rel_err": rel, "max_abs_err": ab,
                    "bar": 5e-3, "launches_of": {kernel.__name__: launched}, "ok": rel <= 5e-3 and launched == 1})
    return out


def reset_variant_counts() -> None:
    from stabletts_torch.ops import attention_packed_cuda as ap
    from stabletts_torch.ops import attention_variants_cuda as av

    ap.attention_packed.launches = 0
    av.attention_packed_v2.launches = av.attention_packed_rope.launches = av.attention_packed_kt.launches = 0
    av.rope_rotate_packed.launches = 0
    av.attention_decompose.launches = {m: 0 for m in av.DECOMPOSE_MODES}


def phase_attention_variants(dev) -> tuple:
    """The variant kernels against their plain versions at (2, 97),
    (16, 1024) and the tools' (64, 1000), f32 and bf16, ragged mask and none
    where the function has a mask; #7's rotation alone at the same shapes;
    the adapters; then the port's attention
    tools on the card at (64, 1000) bf16, a few iterations each, with the
    launches of every kernel per tool run. Returns the tools'-shape rows
    (bf16, no mask) keyed by kernel and the launches {kernel: {tool: n}}."""
    from stabletts_torch.tools import attn_bench, attn_exp

    rng = np.random.default_rng(4321)
    rows, line_rows = [], {}
    for name in VARIANT_KERNELS:
        masks = (False,) if name.startswith("attention_decompose") else (True, False)
        for b, t in ((2, 97), (16, 1024), (64, 1000)):
            for dtype in (torch.float32, torch.bfloat16):
                for masked in masks:
                    row = check_attention_variant(rng, name, b, t, dtype, dev, masked)
                    emit({"phase": "attention_variants", **with_core(row)})
                    rows.append(row)
                    if (b, t, dtype, masked) == (64, 1000, torch.bfloat16, False):
                        line_rows[name] = row
    for b, t in ((2, 97), (16, 1024), (64, 1000)):
        for dtype in (torch.float32, torch.bfloat16):
            row = check_rope_packed(rng, b, t, dtype, dev)
            emit({"phase": "attention_variants", **with_core(row)})
            rows.append(row)
            if (b, t, dtype) == (64, 1000, torch.bfloat16):
                line_rows["rope_packed"] = row
    for row in check_variant_adapters(rng, 2, 97, dev):
        emit({"phase": "attention_variants", **with_core(row)})
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} attention variant check(s) over their bar: {bad}")

    launches, tool_rows = {}, []
    for tool, run in (("attn_bench", lambda: attn_bench.main(dev, 64, 1000, list(attn_bench.VARIANTS), iters=3)),
                      ("attn_exp", lambda: attn_exp.main(dev, 64, 1000, iters=3))):
        reset_variant_counts()
        tool_rows += run()
        torch.cuda.synchronize()
        for name, n in attn_bench.launch_counts().items():
            launches.setdefault(name, {})[tool] = n
    emit({"phase": "attention_tools", "launches": launches})
    bad = [r for r in tool_rows if "rel_err" in r and (not r["finite"] or (r["rel_err"] or 0.0) > r["bar"])]
    missing = [name for name in (*VARIANT_KERNELS, "rope_packed") if sum(launches[name].values()) == 0]
    if bad or missing:
        fail(f"attention tools: rows over their bar {bad}; kernels never launched {missing}")
    return line_rows, launches


def _train_inputs(kind, b, t, dtype, dev):
    """Inputs of a training kernel at flagship widths (C=256, F=1024, 4 heads
    of 64): x masked to ragged lengths, mod [B, 3, C], the weights."""
    rng = np.random.default_rng(b * 7919 + t)
    c, f = 256, 1024
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    lengths = torch.tensor([t - (i * 37) % max(1, t // 2) for i in range(b)], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()
    x = g(b, t, c) * mask[..., None].to(dtype)
    mod = g(b, 3, c, scale=0.3)
    if kind == "ffn_train":
        ws = [g(3, c, f, scale=(3 * c) ** -0.5), g(f, scale=0.05), g(3, f, c, scale=(3 * f) ** -0.5),
              g(c, scale=0.05)]
    else:
        ws = [w for _ in range(4) for w in (g(c, c, scale=c ** -0.5), g(c, scale=0.05))]
    return x, mod, mask, ws, g(b, t, c)


def check_train(kind, b, t, dtype, rate, dev) -> list:
    """A training kernel pair against autograd through its plain version on
    the same inputs and the same Philox bits: the forward and every gradient
    (mod split into shift, scale, gate; 8 gradients for the FFN, 12 for the
    attention), each as max-abs-err / max-abs-plain. Returns the fwd row (the
    output's error) and the bwd row (the worst gradient's); each is ok only
    if all of them are within the bar."""
    from stabletts_torch.ops import dit_attention_train_cuda as A
    from stabletts_torch.ops import ffn_train_cuda as F
    from stabletts_torch.ops import philox

    heads, c, f = 4, 256, 1024
    x, mod, mask, ws, cot = _train_inputs(kind, b, t, dtype, dev)
    seed = philox.draw_seed(torch.Generator(device=dev).manual_seed(b + t), dev)
    if kind == "ffn_train":
        kern = lambda *a: F.ffn_train(a[0], a[1], mask, *a[2:], rate, seed)
        plain = lambda *a: F.ffn_train_plain(a[0], a[1], mask, *a[2:], rate, seed)
        names = ["dw1", "db1", "dw2", "db2"]
        run_fwd = lambda: F.ffn_train_fwd(x, mod, mask, *ws, rate, seed)
        run_bwd = lambda: F.ffn_train_bwd(x, mod, mask, *ws, rate, seed, cot)
        flops = 12 * b * t * c * f
        keep = philox.ffn_keep(seed, b, t, f, rate) if rate > 0 else None
    else:
        kern = lambda *a: A.dit_attention_train(a[0], a[1], mask, *a[2:], heads, rate, seed)
        plain = lambda *a: A.dit_attention_train_plain(a[0], a[1], mask, *a[2:], heads, rate, seed)
        names = ["dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo"]
        wqkv, bqkv = torch.cat(ws[0:6:2], dim=1).contiguous(), torch.cat(ws[1:6:2]).contiguous()
        run_fwd = lambda: A.dit_attention_train_fwd(x, mod, mask, wqkv, bqkv, ws[6], ws[7], heads, rate, seed)
        _, att, lse, att_lo = run_fwd()
        run_bwd = lambda: A.dit_attention_train_bwd(x, mod, mask, wqkv, bqkv, ws[6], ws[7], heads, rate, seed,
                                                    att, lse, cot, att_lo=att_lo)
        flops = 2 * b * t * c * 4 * c + 4 * b * heads * t * t * (c // heads)
        keep = philox.attention_keep(seed, b, heads, t, rate) if rate > 0 else None
    kept = float((keep > 0).float().mean()) if keep is not None else None
    n_keep = keep.numel() if keep is not None else 0
    del keep

    leaves = [a.detach().clone().requires_grad_() for a in (x, mod, *ws)]
    out_k = kern(*leaves)
    g_k = torch.autograd.grad(out_k, leaves, cot)
    out_p = plain(*leaves)
    g_p = torch.autograd.grad(out_p, leaves, cot, retain_graph=True)
    split = lambda gs: [gs[0], gs[1][:, 0], gs[1][:, 1], gs[1][:, 2], *gs[2:]]
    errs = {name: rel_err(a, r) for name, a, r in
            zip(["out", "dx", "dshift", "dscale", "dgate", *names], [out_k, *split(g_k)], [out_p, *split(g_p)])}
    worst_grad = max((k for k in errs if k != "out"), key=lambda k: errs[k][0])
    bar = BARS[kind][dtype]
    all_ok = max(e[0] for e in errs.values()) <= bar
    # the kept share: within 1e-3 of 0.9 where 3 sigma of the count is under
    # 1e-3 (over a million weights), within 3 sigma otherwise
    sigma3 = 3 * (0.09 / n_keep) ** 0.5 if n_keep else 0.0
    kept_ok = kept is None or abs(kept - 0.9) <= max(1e-3, sigma3)

    w_bytes = nbytes(*ws)
    fwd_bytes = nbytes(x, mod, mask) + w_bytes + nbytes(x)
    bwd_bytes = nbytes(x, mod, mask, cot) + w_bytes + nbytes(x) + b * 3 * c * 4 + 2 * w_bytes
    iters = 5 if b * t > 4096 else 10
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: plain(x, mod, *ws), iters=iters)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(out_p, leaves, cot, retain_graph=True), iters=iters)
    rows = []
    for half, out, run, fl, by, pms in (("fwd", "out", run_fwd, flops, fwd_bytes, plain_fwd_ms),
                                        ("bwd", worst_grad, run_bwd, 3 * flops, bwd_bytes, plain_bwd_ms)):
        bound, bound_by = bound_ms(fl, by, dtype)
        rows.append({"kernel": f"{kind}_{half}", "dtype": DT_NAME[dtype], "B": b, "T": t, "dropout": rate,
                     "rel_err": errs[out][0], "max_abs_err": errs[out][1], "worst_output": out, "bar": bar,
                     "kept_share": kept, "ok": all_ok and kept_ok, "ms": time_ms(run, iters=iters),
                     "plain_ms": pms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None})
    del out_p, g_p
    return rows


def check_mas(b, ty, tx, t_ys, t_xs, dev, time_plain=True) -> dict:
    """The MAS kernel against the plain DP on the same neg_cent: exact. With
    the kernel's plan for the shape (decision bits in shared memory or in a
    workspace, chain warps, cells a lane) and one call's device ms from the
    profiler; the plain version's time is the median of two calls, or the
    one call of the comparison where `time_plain` is False."""
    from stabletts_torch.ops.mas import maximum_path
    from stabletts_torch.ops.mas_cuda import mas_plan, maximum_path_cuda
    from stabletts_torch.tools.device_time import device_ms

    rng = np.random.default_rng(ty + tx)
    neg = torch.from_numpy(rng.standard_normal((b, ty, tx)).astype(np.float32)).to(dev)
    t_ys, t_xs = torch.tensor(t_ys, device=dev), torch.tensor(t_xs, device=dev)
    mask = ((torch.arange(ty, device=dev)[None, :] < t_ys[:, None])[:, :, None]
            & (torch.arange(tx, device=dev)[None, :] < t_xs[:, None])[:, None, :]).float()
    got = maximum_path_cuda(neg, mask)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = maximum_path(neg, mask)
    end.record()
    end.synchronize()
    cells = int((got != want).sum())
    ms = time_ms(lambda: maximum_path_cuda(neg, mask))
    dev_ms, by_kernel = device_ms(lambda: maximum_path_cuda(neg, mask), calls=5)
    bound, bound_by = bound_ms(0, nbytes(neg, got), torch.float32)  # neg_cent read, path written
    plain_ms = time_ms(lambda: maximum_path(neg, mask), iters=2, warmup=1) if time_plain else start.elapsed_time(end)
    return {"kernel": "mas", "dtype": "float32", "B": b, "Ty": ty, "Tx": tx, "plan": mas_plan(b, ty, tx),
            "cells_differing": cells, "max_abs_err": float((got - want).abs().max()), "bar": 0, "ok": cells == 0,
            "ms": ms, "device_ms": dev_ms, "by_kernel": by_kernel, "ms_per_mel_row": ms / ty, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def phase_train_kernels(dev) -> dict:
    """The training kernels at (B=32, T=1024), (32, 512) and a ragged (2, 97),
    f32 and bf16, dropout 0 and 0.1, and at the decoder's shape in the
    trainer, (32, 1000), f32, dropout 0.1 (also in bf16, and the attention
    half in bf16 at dropout 0); MAS at [32, 1000, 384] and [32, 1000, 512] with
    ragged lengths and at degenerate lengths, and at shapes that run each
    form of the MAS kernel. Returns the rows of the kernels line: (32, 1000,
    dropout 0.1) f32, and bf16 for the attention half; MAS at [32, 1000,
    512]."""
    rows, line_rows = [], {}
    f32, bf = torch.float32, torch.bfloat16
    cases = [(b, t, dt, rate) for b, t in ((32, 1024), (32, 512), (2, 97)) for dt in (f32, bf)
             for rate in (0.0, 0.1)] + [(32, 1000, f32, 0.1)]
    for kind in ("ffn_train", "dit_attention_train"):
        extra = [(32, 1000, bf, 0.1), (32, 1000, bf, 0.0)] if kind == "dit_attention_train" else [(32, 1000, bf, 0.1)]
        for b, t, dt, rate in cases + extra:
            for row in check_train(kind, b, t, dt, rate, dev):
                emit({"phase": "kernel_check", **with_core(row)})
                rows.append(row)
                if (b, t, rate) == (32, 1000, 0.1):
                    line_rows[row["kernel"] + ("_bf16" if dt == bf else "")] = row
            torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    for tx in (384, 512):
        t_ys = rng.integers(901, 1001, size=32)
        t_xs = np.minimum(rng.integers(tx // 3, tx + 1, size=32), t_ys)
        t_xs[0] = tx
        rows.append(check_mas(32, 1000, tx, t_ys.tolist(), t_xs.tolist(), dev))
        emit({"phase": "kernel_check", **with_core(rows[-1])})
        if tx == 512:
            line_rows["mas"] = rows[-1]
    # tools/tpu_selftest.py:227-237's degenerate lengths (t_x = 1, t_y = t_x = 12, ...)
    rows.append(check_mas(8, 300, 120, [300, 250, 123, 77, 300, 12, 299, 150],
                          [120, 100, 120, 50, 1, 12, 64, 120], dev))
    emit({"phase": "kernel_check", **with_core(rows[-1])})
    # each form of the kernel (tests/test_torch_mas.py::KERNEL_FORM_CASES): four chain warps with the decision bits in
    # shared memory ([4, 1000, 1024]) and in the workspace ([2, 2000, 1024]), five warps of 32 cells a lane
    # ([2, 300, 5000]) and one warp with 4-byte copies (Tx % 4 != 0); each with degenerate lengths beside ragged
    # ones (t_x = 1, t_y = t_x, t_x > t_y)
    for b, ty, tx, t_ys, t_xs in MAS_FORMS:
        rows.append(check_mas(b, ty, tx, t_ys, t_xs, dev, time_plain=False))
        emit({"phase": "kernel_check", **with_core(rows[-1])})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} training kernel check(s) over their bar: {bad}")
    return line_rows


def _grad_rows(kind, dtype, shape, errs, run_fwd, run_bwd, plain_fwd_ms, plain_bwd_ms, fwd, bwd, extra=None,
               library=(None, None)) -> list:
    """The fwd and bwd `kernel_check` rows of a differentiable kernel pair:
    `errs` maps each output ("out", then the gradients) to (rel, abs) error
    against autograd through the plain version; fwd and bwd are (flops,
    bytes) of the two passes. Both rows are ok only if every output is
    within the bar."""
    bar = BARS[kind][dtype]
    worst_grad = max((k for k in errs if k != "out"), key=lambda k: errs[k][0])
    all_ok = max(e[0] for e in errs.values()) <= bar
    iters = 5 if shape["B"] * shape["T"] > 4096 else 10
    rows = []
    for half, out, run, (fl, by), pms, lib in (("fwd", "out", run_fwd, fwd, plain_fwd_ms, library[0]),
                                               ("bwd", worst_grad, run_bwd, bwd, plain_bwd_ms, library[1])):
        bound, bound_by = bound_ms(fl, by, dtype)
        rows.append({"kernel": f"{kind}_{half}", "dtype": DT_NAME[dtype], **shape, "rel_err": errs[out][0],
                     "max_abs_err": errs[out][1], "worst_output": out, "bar": bar, "ok": all_ok,
                     "ms": time_ms(run, iters=iters), "plain_ms": pms, "bound_ms": bound, "bound_by": bound_by,
                     "library_ms": None if lib is None else time_ms(lib, iters=iters), **(extra or {})})
    return rows


def check_attention_train(b, t, dtype, rate, dev, offset: float = 0.0) -> list:
    """Packed-head attention with dropout, forward and dq, dk, dv, against
    autograd through the plain version on the same inputs and Philox bits, on
    the valid query rows (the padded rows get no cotangent and must be
    finite). With `offset`, every key and value shares a mean of that size
    and q is small, as behind a projection with a bias: the true dq and dk
    then cancel over the keys, and an error in a row's D = rowsum(d_o * o)
    does not. In bf16 that case also runs the backward without the output's
    rounding remainder and reports what the remainder buys. The library
    yardstick is one scaled_dot_product_attention call
    with `dropout_p` and the same key mask (its own dropout bits), forward,
    and forward plus backward minus forward for the bwd row."""
    import torch.nn.functional as F

    from stabletts_torch.ops import attention_train_cuda as A
    from stabletts_torch.ops import philox

    c, heads, d = 256, 4, 64
    rng = np.random.default_rng(b * 131 + t)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    mask = _ragged_mask(b, t, dev)
    rows_valid = (mask > 0)[..., None].to(dtype)
    q, k, v = g(b, t, c), g(b, t, c), g(b, t, c)
    if offset:
        q, k, v = q * 0.3, k + offset * g(1, 1, c), v + offset * g(1, 1, c)
    cot = g(b, t, c) * rows_valid
    seed = philox.draw_seed(torch.Generator(device=dev).manual_seed(b + t), dev)

    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out_k = A.attention_train(*leaves, mask, rate, seed, heads)
    g_k = torch.autograd.grad(out_k, leaves, cot)
    finite = bool(torch.isfinite(out_k).all())
    out_p = A.attention_train_plain(*leaves, mask, rate, seed, heads)
    g_p = torch.autograd.grad(out_p, leaves, cot, retain_graph=True)
    errs = {name: rel_err(a, r) for name, a, r in
            zip(["out", "dq", "dk", "dv"], [out_k * rows_valid, *g_k], [out_p * rows_valid, *g_p])}
    if not finite:
        errs["out"] = (math.inf, math.inf)

    iters = 5 if b * t > 4096 else 10
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: A.attention_train_plain(q, k, v, mask, rate, seed, heads), iters=iters)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(out_p, leaves, cot, retain_graph=True), iters=iters)
    o, lse, o_lo = A.attention_train_fwd(q, k, v, mask, heads, rate, seed)
    run_fwd = lambda: A.attention_train_fwd(q, k, v, mask, heads, rate, seed)
    run_bwd = lambda: A.attention_train_bwd(q, k, v, mask, heads, rate, seed, o, lse, cot, o_lo)

    key_mask = (mask > 0)[:, None, None, :]
    bhtd = lambda a: a.view(b, t, heads, d).transpose(1, 2)
    lq, lk, lv = (bhtd(a).detach().requires_grad_() for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=key_mask, dropout_p=rate)
    with torch.no_grad():
        lib_fwd_ms = time_ms(sdpa, iters=iters)
    lib_both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (lq, lk, lv), bhtd(cot)), iters=iters)
    flops = 4 * b * heads * t * t * d
    lo = [] if o_lo is None else [o_lo]  # bf16: the output's rounding remainder, written forward, read backward
    fwd_bytes = nbytes(q, k, v, mask, q, *lo)
    shape = {"B": b, "T": t, "dropout": rate, **({"kv_offset": offset} if offset else {})}
    rows = _grad_rows("attention_train", dtype, shape, errs, run_fwd, run_bwd,
                      plain_fwd_ms, plain_bwd_ms, (flops, fwd_bytes),
                      (2.5 * flops, nbytes(q, k, v, mask, cot, q, k, v, *lo)))
    rows[0]["library_ms"] = lib_fwd_ms
    rows[1]["library_ms"] = max(lib_both_ms - lib_fwd_ms, 0.0)
    rows[1]["library_fwd_and_bwd_ms"] = lib_both_ms
    if offset and o_lo is not None:
        # the kernel rounds ds to bf16 before its products, as the TPU kernel does and autograd through the plain
        # version does not; where dq cancels over the keys that rounding shows (0.023 seen at offset 2)
        for row in rows:
            row["bar"], row["ok"] = 5e-2, max(e[0] for e in errs.values()) <= 5e-2
        bare = A.attention_train_bwd(q, k, v, mask, heads, rate, seed, o, lse, cot, torch.zeros_like(o_lo))
        rows[1]["rel_err_dq_dk_dv"] = [errs[n][0] for n in ("dq", "dk", "dv")]
        rows[1]["rel_err_dq_dk_dv_without_remainder"] = [rel_err(a, r)[0] for a, r in zip(bare, g_p)]
    del out_p, g_p
    return rows


def check_prenet_train(b, t, dtype, dev) -> list:
    """The mu prenet, forward, dmu and the six parameter gradients, against
    autograd through the plain version (flagship widths 128 -> 1024 -> 1024
    -> 256)."""
    from stabletts_torch.ops import prenet_train_cuda as P

    cin, f, cout = 128, 1024, 256
    rng = np.random.default_rng(b * 257 + t)
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    mu = g(b, t, cin)
    ws = [g(3, cin, f, scale=(3 * cin) ** -0.5), g(f, scale=0.05), g(3, f, f, scale=(3 * f) ** -0.5), g(f, scale=0.05),
          g(3, f, cout, scale=(3 * f) ** -0.5), g(cout, scale=0.05)]
    cot = g(b, t, cout)
    leaves = [a.detach().clone().requires_grad_() for a in (mu, *ws)]
    out_k = P.prenet_train(*leaves)
    g_k = torch.autograd.grad(out_k, leaves, cot)
    out_p = P.prenet_train_plain(*leaves)
    g_p = torch.autograd.grad(out_p, leaves, cot, retain_graph=True)
    names = ["out", "dmu", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    errs = {name: rel_err(a, r) for name, a, r in zip(names, [out_k, *g_k], [out_p, *g_p])}
    iters = 5 if b * t > 4096 else 10
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: P.prenet_train_plain(mu, *ws), iters=iters)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(out_p, leaves, cot, retain_graph=True), iters=iters)
    flops = 6 * b * t * (cin * f + f * f + f * cout)
    # the backward: an input gradient and a weight gradient for each conv, and conv_a and conv_b again (conv_c's
    # output is not needed)
    bwd_flops = 2 * flops + 6 * b * t * (cin * f + f * f)
    w_bytes = nbytes(*ws)
    rows = _grad_rows("prenet_train", dtype, {"B": b, "T": t}, errs, lambda: P.prenet_train_fwd(mu, *ws),
                      lambda: P.prenet_train_bwd(mu, *ws, cot), plain_fwd_ms, plain_bwd_ms,
                      (flops, nbytes(mu, cot) + w_bytes),
                      (bwd_flops, nbytes(mu, cot, mu) + w_bytes + 4 * sum(w.numel() for w in ws)))
    del out_p, g_p
    return rows


def check_istft_diff(b, t, dtype, dev) -> dict:
    """`istft_head_diff` (the ISTFT kernel forward, the transposed plain ISTFT
    as its backward) against autograd through the plain ISTFT: the waveform
    at the ISTFT kernel's bar, d(re) and d(im) at 1e-4 (both backwards are the
    same f32 transpose). One `istft_head` launch per forward."""
    from stabletts_torch.ops.istft import istft_same_real
    from stabletts_torch.ops.istft_cuda import istft_head, istft_head_diff

    n_fft, hop = 2048, 512
    nf = n_fft // 2 + 1
    rng = np.random.default_rng(b + t)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    re, im, cot = g(b, t, nf), g(b, t, nf), g(b, t * hop)
    md = None if dtype == torch.float32 else dtype
    outs = {}
    before = istft_head.launches
    for name, fn in (("kernel", lambda r, i: istft_head_diff(r, i, n_fft, hop, md)),
                     ("plain", lambda r, i: istft_same_real(r, i, n_fft, hop, n_fft, md))):
        leaves = [re.clone().requires_grad_(), im.clone().requires_grad_()]
        out = fn(*leaves)
        outs[name] = [out.detach(), *torch.autograd.grad(out, leaves, cot)]
    launched = istft_head.launches - before
    errs = [rel_err(a, r) for a, r in zip(outs["kernel"], outs["plain"])]
    bar = BARS["istft"][dtype]
    # in bf16 the plain backward differentiates its quantised matmul; the kernel's is the f32 transpose
    grad_bar = 1e-4 if dtype == torch.float32 else 2e-2
    ok = launched == 1 and errs[0][0] <= bar and max(errs[1][0], errs[2][0]) <= grad_bar
    leaves = [re.clone().requires_grad_(), im.clone().requires_grad_()]
    both = lambda: torch.autograd.grad(istft_head_diff(*leaves, n_fft, hop, md), leaves, cot)
    return {"kernel": "istft_diff", "dtype": DT_NAME[dtype], "B": b, "T": t, "rel_err": errs[0][0],
            "max_abs_err": errs[0][1], "grad_rel_err": max(errs[1][0], errs[2][0]), "bar": bar, "grad_bar": grad_bar,
            "launches_of_istft_head": launched, "fwd_and_bwd_ms": time_ms(both), "ok": ok}


def mpd_flops(bsz: int, t: int, period: int) -> float:
    """Multiply-adds x 2 of convs 1-4 and conv_post (what the kernel runs)."""
    from stabletts_torch.ops.mpd_cuda import layer_lens

    lens = layer_lens(-(-t // period))
    ch = (32, 128, 512, 1024, 1024)
    fl = sum(2 * bsz * period * lens[i + 1] * 5 * ch[i - 1] * ch[i] for i in range(1, 5))
    return fl + 2 * bsz * period * lens[6] * 3 * 1024


def mpd_library(x, folded, period) -> tuple:
    """What one cuDNN `F.conv2d` call a conv computes of the kernel's part
    (convs 1-4 with their bias, before the leaky ReLU, and conv_post), each
    on its own input from the plain version: (the five calls' median ms
    summed, [ms of each])."""
    import torch.nn.functional as F

    from stabletts_torch.ops.mpd_cuda import LEAK, fold_period

    with torch.no_grad():
        h = fold_period(x.float(), period)
        ins = []
        for i in range(5):
            w, b = folded[i]
            if i > 0:
                ins.append(h)
            h = F.leaky_relu(F.conv2d(h, w.float(), b.float(), (3 if i < 4 else 1, 1), (2, 0)), LEAK)
        ins.append(h)
        convs = [(ins[i - 1], folded[i], (3 if i < 4 else 1, 1), (2 if i < 5 else 1, 0)) for i in range(1, 6)]
        each = [time_ms(lambda h=h, w=w, st=st, pd=pd: F.conv2d(h, w[0].float(), w[1].float(), st, pd), iters=5)
                for h, w, st, pd in convs]
    return sum(each), each


def mpd_layers(x, folded, period) -> list:
    """Convs 1-4 one by one as the stack runs them, each the f32 tap GEMM
    with its row stride (the bare `tap_gemm`, which stores the sums where the
    stack's epilogue adds the bias and the leaky ReLU) on the plain version's
    input to that conv: per layer the device ms of a launch (torch.profiler
    over five calls: the kernel's device time over the launches it recorded),
    the CUDA-event median of a call, its bound (operations at the f32 peak)
    and cuDNN's `F.conv2d` of the same conv (CUDA events, TF32 off)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stabletts_torch.ops.mpd_cuda import LEAK, fold_period
    from stabletts_torch.ops.tap_gemm_cuda import tap_gemm

    def per_launch(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "tap_gemm_f32_kernel" in e.key]
        n = sum(e.count for e in ev)
        return sum(e.self_device_time_total for e in ev) / max(n, 1) / 1e3, n

    rows = []
    with torch.no_grad():
        h = F.leaky_relu(F.conv2d(fold_period(x.float(), period), folded[0][0].float(), folded[0][1].float(), (3, 1),
                                  (2, 0)), LEAK)
        for i in range(1, 5):
            w, bias = folded[i]
            stride = 3 if i < 4 else 1
            b, c_in, l_in, p = h.shape
            a0 = h.permute(0, 3, 2, 1).reshape(b * p * l_in, c_in).contiguous()  # streams [B * p, L, C]
            wt = w.float()[..., 0].permute(2, 1, 0).contiguous()                  # [5, C_in, C_out]
            l_out = (l_in - 1) // stride + 1
            run = lambda: tap_gemm(a0, wt, t_in=l_in, t_out=l_out, taps=5, shift0=-2, shift_step=1,
                                   row_stride=stride)
            dev_ms, seen = per_launch(run)
            flops = 2 * b * p * l_out * 5 * c_in * w.shape[0]
            rows.append({"layer": i, "M": b * p * l_out, "K": 5 * c_in, "N": w.shape[0], "gflop": flops / 1e9,
                         "device_ms": dev_ms, "launches_recorded": seen, "ms": time_ms(run, iters=5),
                         "bound_ms": bound_ms(flops, 0, torch.float32)[0],
                         "library_ms": time_ms(lambda: F.conv2d(h, w.float(), bias.float(), (stride, 1), (2, 0)),
                                               iters=5)})
            h = F.leaky_relu(F.conv2d(h, w.float(), bias.float(), (stride, 1), (2, 0)), LEAK)
    return rows


def check_mpd_stack(x, folded, period, disc=None) -> dict:
    """`mpd_stack` against its plain version on x [B, T] (and against
    `disc`, a DiscriminatorP holding the same weights): the logits and the
    five feature maps, max-abs 2e-4. With the device ms of each kernel of a
    call (`by_kernel`, torch.profiler: conv 0 and the layout copies in
    PyTorch, the four tap GEMMs, conv_post) and the cuDNN composition of the
    kernel's five convs (`library_ms`, TF32 off, `library_by_conv`)."""
    from stabletts_torch.ops.mpd_cuda import mpd_stack, mpd_stack_plain
    from stabletts_torch.tools.device_time import device_ms

    logits, fmap = mpd_stack(x, folded, period)
    with torch.no_grad():
        p_logits, p_fmap = mpd_stack_plain(x, folded, period)
        errs = [rel_err(a, r) for a, r in zip([logits, *fmap], [p_logits, *p_fmap])]
        shapes_ok = all(a.shape == r.shape for a, r in zip([logits, *fmap], [p_logits, *p_fmap]))
        disc_abs = None
        if disc is not None:
            d_logits, d_fmap = disc(x, folded)
            disc_abs = max(float((a - r).abs().max()) for a, r in zip([logits, *fmap], [d_logits, *d_fmap]))
    worst = max(range(6), key=lambda i: errs[i][1])
    b, t = x.shape
    io = nbytes(x, *(w for pair in folded for w in pair), logits, *fmap)
    bound, bound_by = bound_ms(mpd_flops(b, t, period), io, torch.float32)
    max_abs = errs[worst][1]
    ok = shapes_ok and max_abs <= MPD_BAR and (disc_abs is None or disc_abs <= MPD_BAR)
    with torch.no_grad():
        plain_ms = time_ms(lambda: mpd_stack_plain(x, folded, period), iters=5)
    library, library_each = mpd_library(x, folded, period)
    dev_ms, by_kernel = device_ms(lambda: mpd_stack(x, folded, period), calls=3)
    return {"kernel": "mpd_stack", "dtype": "float32", "B": b, "T": t, "period": period, "rel_err": errs[worst][0],
            "max_abs_err": max_abs, "worst_output": ["logits", "f1", "f2", "f3", "f4", "f5"][worst],
            "max_abs_err_vs_discriminator": disc_abs, "bar": MPD_BAR, "ok": ok,
            "ms": time_ms(lambda: mpd_stack(x, folded, period), iters=5), "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library, "library_by_conv": library_each, "device_ms": dev_ms,
            "by_kernel": by_kernel, "gflop": mpd_flops(b, t, period) / 1e9}


def phase_opt_in_train_kernels(dev) -> dict:
    """The kernels of the opt-in training paths and of GAN training at the
    trainers' shapes and one small odd shape each: `attention_train` and
    `prenet_train` at (32, 1000), (32, 1024) and (2, 97), f32 and bf16
    (`attention_train` also at (32, 512), the encoder blocks' shape, and at
    (32, 1000) with dropout 0, which leaves out the Philox work, and in f32
    at (32, 512) with dropout 0);
    `mpd_stack` at [16, 20480] and [2, 8190] for the five periods; the ISTFT
    head's gradient. Returns the rows of the kernels line."""
    from stabletts_torch.models.discriminators import DiscriminatorP

    rows, line_rows = [], {}
    f32, bf = torch.float32, torch.bfloat16
    for b, t, dt, rate in [(32, 1000, f32, 0.1), (32, 1000, bf, 0.1), (32, 1024, f32, 0.1), (32, 1024, bf, 0.1),
                           (32, 512, f32, 0.1), (32, 512, bf, 0.1), (32, 1000, f32, 0.0), (32, 1000, bf, 0.0),
                           (32, 512, f32, 0.0),
                           (2, 97, f32, 0.1), (2, 97, bf, 0.1), (4, 200, bf, 0.1), (4, 200, f32, 0.1)]:
        # the last two: keys and values with a common mean (see check_attention_train)
        for row in check_attention_train(b, t, dt, rate, dev, offset=2.0 if (b, t) == (4, 200) else 0.0):
            rows.append(row)
            if (b, t, rate) == (32, 1000, 0.1):
                line_rows[row["kernel"] + ("_bf16" if dt == bf else "")] = row
        torch.cuda.empty_cache()
    for b, t, dt in [(32, 1000, f32), (32, 1000, bf), (32, 1024, f32), (32, 1024, bf), (2, 97, f32), (2, 97, bf)]:
        for row in check_prenet_train(b, t, dt, dev):
            rows.append(row)
            if (b, t, dt) == (32, 1000, f32):
                line_rows[row["kernel"]] = row
        torch.cuda.empty_cache()
    for b, t in ((16, 20480), (2, 8190)):
        x = torch.from_numpy((np.random.default_rng(t).standard_normal((b, t)) * 0.3).astype(np.float32)).to(dev)
        for period in (2, 3, 5, 7, 11):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(period)
                disc = DiscriminatorP(period).to(dev)
            with torch.no_grad():
                folded = disc.fold()
            rows.append(check_mpd_stack(x, folded, period, disc))
            if (b, period) == (16, 2):
                line_rows["mpd_stack"] = rows[-1]
                emit({"phase": "mpd_layers", "B": b, "T": t, "period": period,
                      "layers": mpd_layers(x, folded, period)})
    # the ISTFT head's gradient at the GAN trainer's shape (B=16, 40 frames) and one odd shape
    rows += [check_istft_diff(b, t, dt, dev) for b, t, dt in ((16, 40, f32), (16, 40, bf), (3, 77, f32))]
    for row in rows:
        emit({"phase": "kernel_check", **with_core(row)})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} opt-in training kernel check(s) over their bar: {bad}")
    return line_rows


# ---------------------------------------------------------------- serving --


def counters():
    from stabletts_torch.ops.adaln_ffn_cuda import adaln_ffn
    from stabletts_torch.ops.attention_packed_cuda import attention_packed, attention_packed_t
    from stabletts_torch.ops.convnext_cuda import convnext_block
    from stabletts_torch.ops.dit_attention_cuda import dit_attention
    from stabletts_torch.ops.dit_block_cuda import dit_block
    from stabletts_torch.ops.istft_cuda import istft_head

    return {"dit_block": dit_block, "dit_attention": dit_attention, "adaln_ffn": adaln_ffn,
            "attention_packed": attention_packed, "attention_packed_t": attention_packed_t,
            "convnext": convnext_block, "istft": istft_head}


def expected_counts(**nonzero) -> dict:
    return {**{name: 0 for name in counters()}, **nonzero}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def randomise(model, seed: int) -> None:
    """adaLN and the CFG embeddings of a StableTTS model from a numpy seed
    (adaLN-Zero would make every DiT block the identity)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "adaLN_modulation" in name or name.startswith("fake_"):
                scale = 0.1 if "adaLN" in name else 0.5
                p.copy_(torch.from_numpy((rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)))


def reference_wave(seed: int, seconds: float = 3.0, sr: int = 44100) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 330 * t) + 0.02 * rng.standard_normal(t.size)
    return wav.astype(np.float32)


SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Flow matching turns noise into a mel spectrogram in ten steps.",
    "Please call Stella and ask her to bring these things with her from the store.",
]


# the requests of phase `serving_languages`. The machine with the card has no jieba, so the Chinese request starts from
# its sentence's phoneme ids (cleaned_text_to_sequence(chinese_to_cnm3(ZH_SENTENCE)), before the blanks), pinned here
# and held to both packages' frontends by tests/test_torch_frontends.py. The mixed sentence has nothing between or
# after its spans: the router reads such punctuation through the Chinese g2p, which needs jieba.
JA_SENTENCE = "明日の朝八時に駅で会いましょう"
ZH_SENTENCE = "今天天气很好，我们一起去公园散步吧。"
ZH_IDS = [144, 154, 279, 169, 334, 279, 169, 334, 279, 102, 157, 176, 251, 281, 176, 241, 316, 1, 106, 151, 168, 253,
          283, 69, 154, 101, 156, 102, 187, 179, 369, 344, 70, 380, 280, 142, 277, 282, 117, 202, 114, 194, 2]
AUTO_SENTENCE = "今日の会議はZoomで行います"


def phase_serving(dev, card: str) -> tuple:
    from stabletts_torch.api import StableTTSAPI
    from stabletts_torch.models.sampler import cast_model, synthesise
    from stabletts_torch.text import symbols

    api = StableTTSAPI(device=dev)
    randomise(api.tts_model, seed=7)
    tts_m, voc_m = api.get_params()
    emit({"phase": "serving_model", "tts_params_M": tts_m, "vocoder_params_M": voc_m})
    ref = reference_wave(3)
    sr, hop = api.mel_config.sample_rate, api.mel_config.hop_length

    with counting_synthesise() as n_synth:
        api.inference(SENTENCES[0], ref, "english", step=10, cfg=3.0)  # warm: allocator, cuDNN plans
        torch.cuda.synchronize()
        main_counts = expected_counts()  # summed over the inference requests
        for i, text in enumerate(SENTENCES):
            reset_counts()
            n_synth[0] = 0
            t0 = time.time()
            wav, mel = api.inference(text, ref, "english", step=10, cfg=3.0, seed=i)
            wall = time.time() - t0
            counts = read_counts()
            for k, v in counts.items():
                main_counts[k] += v
            expect = expected_counts(dit_block=63 * n_synth[0], convnext=8, istft=1)
            ok = counts == expect and np.isfinite(wav).all() and wav.shape[1] == mel.shape[2] * hop
            emit({"phase": "serving_request", "text_chars": len(text), "frames": int(mel.shape[2]),
                  "wall_ms": wall * 1e3, "audio_s_per_s": wav.shape[1] / sr / wall, "launches": counts,
                  "expected_launches": expect, "card": card, "ok": bool(ok)})
            if not ok:
                fail(f"serving request {i}: launches {counts} vs {expect}, or bad output shape/values")

        reset_counts()
        n_synth[0] = 0
        t0 = time.time()
        wavs = api.batch_inference([(s, "english") for s in SENTENCES], ref, step=10, cfg=3.0)
        wall = time.time() - t0
        counts = read_counts()
        expect = expected_counts(dit_block=63 * n_synth[0], convnext=8, istft=1)
        ok = counts == expect and len(wavs) == len(SENTENCES) and all(np.isfinite(w).all() for w in wavs)
        emit({"phase": "serving_batch", "items": len(wavs), "wall_ms": wall * 1e3,
              "audio_s_per_s": sum(w.shape[0] for w in wavs) / sr / wall, "launches": counts,
              "expected_launches": expect, "card": card, "ok": bool(ok)})
        if not ok:
            fail(f"batch_inference: launches {counts} vs {expect}, or bad outputs")

    # bench shape: B=8, 96 phoneme ids, 1000 frames, 10 Euler steps, CFG 3, bf16
    b, frames, tx = 8, 1000, 96
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, len(symbols), size=(b, tx))).to(dev)
    x_lengths = torch.full((b,), tx, device=dev)
    noise = torch.from_numpy(rng.standard_normal((b, frames, 128)).astype(np.float32)).to(dev)
    y_ref = torch.from_numpy(rng.standard_normal((b, 300, 128)).astype(np.float32)).to(dev)
    tts16 = cast_model(api.tts_model, torch.bfloat16)
    voc16 = cast_model(api.vocoder_model, torch.bfloat16)

    def pipeline():
        out = synthesise(tts16, x, x_lengths, noise, y_ref, n_timesteps=10, cfg=3.0, max_mel_len=frames,
                         compute_dtype=torch.bfloat16, device=dev)
        return voc16(out["decoder_outputs"].to(torch.bfloat16))

    pipeline()
    torch.cuda.synchronize()
    reset_counts()
    iters = 3
    t0 = time.time()
    for _ in range(iters):
        wav = pipeline()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / iters
    counts = read_counts()
    expect = expected_counts(dit_block=63 * iters, convnext=8 * iters, istft=iters)
    ok = counts == expect and tuple(wav.shape) == (b, frames * hop) and bool(torch.isfinite(wav).all())
    emit({"phase": "serving_bench_bf16", "B": b, "frames": frames, "steps": 10, "cfg": 3.0,
          "wall_ms": wall * 1e3, "audio_s_per_s": b * frames * hop / sr / wall, "launches": counts,
          "expected_launches": expect, "card": card, "ok": ok})
    if not ok:
        fail(f"bf16 bench batch: launches {counts} vs {expect}, or bad output")
    return api, main_counts, pipeline


@contextlib.contextmanager
def counting_synthesise():
    """Counts the API's synthesise calls (the mel cap's regrowth calls it
    again) in the yielded one-element list."""
    import stabletts_torch.api as api_mod

    real, n_synth = api_mod.synthesise, [0]

    def counting(*a, **k):
        n_synth[0] += 1
        return real(*a, **k)

    api_mod.synthesise = counting
    try:
        yield n_synth
    finally:
        api_mod.synthesise = real


def phase_serving_languages(api, card: str) -> dict:
    """One f32 request (10 Euler steps, CFG 3) in Japanese, in Chinese and in
    mixed ja+en text through `StableTTSAPI.inference`, each twice (the first
    call loads the frontend's dictionaries): wall ms of both, frames, the
    launches of the second against 63 DiT blocks a synthesis, 8 ConvNeXt
    blocks and 1 ISTFT, finite output. The Chinese g2p is the pinned table of
    ZH_IDS. Returns the launches summed over the second calls."""
    from stabletts_torch.text import symbols

    ref = reference_wave(4)
    total = expected_counts()
    real_zh = api.g2p_mapping["chinese"]
    api.g2p_mapping["chinese"] = {ZH_SENTENCE: [symbols[i] for i in ZH_IDS]}.__getitem__
    try:
        with counting_synthesise() as n_synth:
            for lang, text in (("japanese", JA_SENTENCE), ("chinese", ZH_SENTENCE), ("auto", AUTO_SENTENCE)):
                t0 = time.time()
                api.inference(text, ref, lang, step=10, cfg=3.0, seed=0)
                first = time.time() - t0
                reset_counts()
                n_synth[0] = 0
                t0 = time.time()
                wav, mel = api.inference(text, ref, lang, step=10, cfg=3.0, seed=0)
                wall = time.time() - t0
                counts = read_counts()
                for k, v in counts.items():
                    total[k] += v
                expect = expected_counts(dit_block=63 * n_synth[0], convnext=8, istft=1)
                ok = bool(counts == expect and np.isfinite(wav).all() and np.isfinite(mel).all()
                          and wav.shape[1] == mel.shape[2] * api.mel_config.hop_length)
                emit({"phase": "serving_languages", "language": lang, "text": text,
                      "phoneme_ids": len(api._phonemes(text, lang)), "frames": int(mel.shape[2]),
                      "wall_ms": wall * 1e3, "wall_ms_first_call": first * 1e3, "launches": counts,
                      "expected_launches": expect, "card": card, "ok": ok})
                if not ok:
                    fail(f"serving_languages {lang}: launches {counts} vs {expect}, or bad output")
    finally:
        api.g2p_mapping["chinese"] = real_zh
    return total


def _codec_fixtures():
    """tests/torch_codec_fixtures.py (the clip writers), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_codec_fixtures.py")
    spec = importlib.util.spec_from_file_location("torch_codec_fixtures", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX package's bar for a lossy codec's round trip: the aligned waveforms' correlation (tests/test_codecs.py:82)
LOSSY_CORRELATION = 0.98


def _aligned_correlation(ref: np.ndarray, got: np.ndarray, max_lag: int = 4000) -> float:
    """Best normalised correlation of got against ref over lags 0..max_lag (a codec's delay)."""
    n = min(len(ref), len(got)) - max_lag
    a = ref[:n]
    return max(float(np.dot(a, got[lag:lag + n]) / (np.linalg.norm(a) * np.linalg.norm(got[lag:lag + n]) + 1e-12))
               for lag in range(max_lag))


def reference_formats(api, root: str, wave: np.ndarray) -> list:
    """`wave` written under `root` as WAV and FLAC, and as mp3 and ogg where
    their codec libraries are on this machine, each read back as the API
    reads a reference path. FLAC is lossless: its reference mel must equal
    the WAV's. mp3 and ogg must keep LOSSY_CORRELATION with the WAV's
    samples; their mels differ by the codec's delay and loss. One row a
    format, with its path."""
    from stabletts_torch.utils.audio_io import load_and_resample_audio, save_wav

    fx = _codec_fixtures()
    sr = api.mel_config.sample_rate
    wav_path = os.path.join(root, "ref.wav")
    save_wav(wav_path, wave, sr)
    base_mel = api._reference_mel(wav_path)[0]
    base_wave = load_and_resample_audio(wav_path, sr)
    rows = []
    for fmt, libs, write in (("flac", (), fx.write_flac), ("mp3", fx.MP3_LIBS, fx.write_mp3),
                             ("ogg", fx.OGG_LIBS, fx.write_ogg)):
        if not fx.have(*libs):
            rows.append({"format": fmt, "decoded": False, "missing_libraries": [l for l in libs if not fx.have(l)],
                         "ok": True})
            continue
        path = os.path.join(root, f"ref.{fmt}")
        write(path, wave, sr)
        mel = api._reference_mel(path)[0]
        row = {"format": fmt, "decoded": True, "path": path, "frames": int(mel.shape[1]),
               "frames_wav": int(base_mel.shape[1])}
        if fmt == "flac":
            same = mel.shape == base_mel.shape
            row["mel_max_abs_err_vs_wav"] = (mel - base_mel).abs().max().item() if same else math.inf
            row.update(bar=0.0, ok=row["mel_max_abs_err_vs_wav"] == 0.0)
        else:
            row["correlation_vs_wav"] = _aligned_correlation(base_wave, load_and_resample_audio(path, sr))
            row.update(bar=LOSSY_CORRELATION, ok=row["correlation_vs_wav"] >= LOSSY_CORRELATION)
        rows.append(row)
    return rows


def phase_serving_ref_formats(api, card: str) -> dict:
    """`reference_formats` of a clip from a seed, then one f32 request (10
    Euler steps, CFG 3) for each decoded compressed format with that file's
    path as its reference: launches, finite output. Returns the launches
    summed."""
    total = expected_counts()
    with tempfile.TemporaryDirectory() as root, counting_synthesise() as n_synth:
        for row in reference_formats(api, root, reference_wave(9)):
            if row["decoded"]:
                reset_counts()
                n_synth[0] = 0
                t0 = time.time()
                wav, mel = api.inference(SENTENCES[1], row["path"], "english", step=10, cfg=3.0, seed=0)
                row["wall_ms"] = (time.time() - t0) * 1e3
                counts = read_counts()
                for k, v in counts.items():
                    total[k] += v
                expect = expected_counts(dit_block=63 * n_synth[0], convnext=8, istft=1)
                row.update(launches=counts, expected_launches=expect,
                           ok=bool(row["ok"] and counts == expect and np.isfinite(wav).all()))
                row.pop("path")
            emit({"phase": "serving_ref_formats", **row, "card": card})
            if not row["ok"]:
                fail(f"serving_ref_formats: {row}")
    return total


def phase_bench(card: str) -> dict:
    """The port's serving bench (stabletts_torch/tools/bench.py) at its
    defaults with the gate on: its JSON line, then a record of it with the
    peak device memory over the bench. The
    launches of its timed iterations (the headline's and CFG 3's) must be 63
    DiT blocks, 8 ConvNeXt blocks and 1 ISTFT an iteration; they are
    returned, summed."""
    from stabletts_torch.tools import bench as bench_mod

    args = bench_mod.parse_args([])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result = bench_mod.main([])
    seconds = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # with the earlier phases' models still resident
    d = result["detail"]
    iters = {"dit_block": 63 * args.iters, "convnext": 8 * args.iters, "istft": args.iters}
    total = expected_counts()
    for launches in (d["launches"], d["cfg3"]["launches"]):
        for k, v in launches.items():
            total[k] += v
    ok = bool(d["kernel_selftest"] == "pass" and d["platform"] == "gpu" and d["launches"] == iters
              and d["cfg3"]["launches"] == iters and d["cfg3"]["batch"] == 96 and math.isfinite(result["value"])
              and result["value"] > 0 and d["b1"]["latency_ms"] > 0)
    emit({"phase": "bench", "iters": args.iters, "seconds": seconds, "peak_memory_gb": peak_gb,
          "audio_s_per_s": result["value"], "cfg3_audio_s_per_s": d["cfg3"]["audio_s_per_s"],
          "b1_latency_ms": d["b1"]["latency_ms"], "expected_launches_per_measurement": iters, "card": card, "ok": ok})
    if not ok:
        fail(f"bench: {result}")
    torch.cuda.empty_cache()
    return total


BLOCK_VARIABLES = ("STABLETTS_DIT_BLOCK", "STABLETTS_DIT_FUSED", "STABLETTS_FFN_IMPL", "STABLETTS_ATTN_IMPL",
                   "STABLETTS_ATTN_LAYOUT")
# the DiT block's serving configurations and the kernels each launches, per block
BLOCK_CONFIGS = {
    "a_default": ({}, ("dit_block",)),
    "b_two_kernels": ({"STABLETTS_DIT_BLOCK": "0"}, ("dit_attention", "adaln_ffn")),
    "c_composed_attention": ({"STABLETTS_DIT_FUSED": "0"}, ("attention_packed", "adaln_ffn")),
    "d_composed_attention_tminor": ({"STABLETTS_DIT_FUSED": "0", "STABLETTS_ATTN_LAYOUT": "tminor"},
                                    ("attention_packed_t", "adaln_ffn")),
    "e_composed_attention_flash": ({"STABLETTS_DIT_FUSED": "0", "STABLETTS_ATTN_IMPL": "flash"},
                                   ("attention_packed", "adaln_ffn")),
    "f_all_library": ({"STABLETTS_DIT_FUSED": "0", "STABLETTS_FFN_IMPL": "xla", "STABLETTS_ATTN_IMPL": "xla"}, ()),
}


@contextlib.contextmanager
def block_config(name: str):
    """The environment of one block configuration, restored on exit."""
    saved = {v: os.environ.pop(v, None) for v in BLOCK_VARIABLES}
    os.environ.update(BLOCK_CONFIGS[name][0])
    try:
        yield
    finally:
        for v, old in saved.items():
            os.environ.pop(v, None)
            if old is not None:
                os.environ[v] = old


def phase_serving_configs(api, bench_pipeline, card: str) -> dict:
    """The same English request (f32, 10 Euler steps, CFG 3, mel cap 1024,
    the same noise) under each block configuration: its mel within 5e-3 of
    the default's, exactly 63 launches of each kernel of the configuration
    and none of the others, wall ms as the median of 5. Then the bf16 bench
    batch under the two-kernel and the all-library configurations. Returns
    the launches of every DiT kernel summed over the measured requests."""
    ref = reference_wave(3)
    sr, hop = api.mel_config.sample_rate, api.mel_config.hop_length
    request = lambda: api.inference(SENTENCES[0], ref, "english", step=10, cfg=3.0, seed=0)
    total = expected_counts()
    base_mel = None
    for name, (env, kernels) in BLOCK_CONFIGS.items():
        with block_config(name):
            request()  # warm: cuDNN plans of the composed paths
            torch.cuda.synchronize()
            walls, ok = [], True
            expect = expected_counts(convnext=8, istft=1, **{k: 63 for k in kernels})
            for _ in range(5):
                reset_counts()
                t0 = time.time()
                wav, mel = request()
                walls.append(time.time() - t0)
                counts = read_counts()
                ok = ok and counts == expect
                for k, v in counts.items():
                    total[k] += v
        if base_mel is None:
            base_mel = mel
        same_shape = mel.shape == base_mel.shape
        rel = float(np.abs(mel - base_mel).max() / np.abs(base_mel).max()) if same_shape else math.inf
        ok = bool(ok and rel <= 5e-3 and np.isfinite(wav).all() and wav.shape[1] == mel.shape[2] * hop)
        wall = statistics.median(walls)
        emit({"phase": "serving_config", "config": name, "env": env, "frames": int(mel.shape[2]),
              "wall_ms": wall * 1e3, "wall_ms_all": [w * 1e3 for w in walls],
              "audio_s_per_s": wav.shape[1] / sr / wall, "mel_rel_err_vs_default": rel, "bar": 5e-3,
              "launches": counts, "expected_launches": expect, "card": card, "ok": ok})
        if not ok:
            fail(f"serving_config {name}: launches {counts} vs {expect}, mel rel err {rel}, or bad output")

    b, frames, iters = 8, 1000, 2
    for name in ("b_two_kernels", "f_all_library"):
        with block_config(name):
            bench_pipeline()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.time()
            for _ in range(iters):
                wav = bench_pipeline()
            torch.cuda.synchronize()
            wall = (time.time() - t0) / iters
            counts = read_counts()
        expect = expected_counts(convnext=8 * iters, istft=iters, **{k: 63 * iters for k in BLOCK_CONFIGS[name][1]})
        ok = counts == expect and tuple(wav.shape) == (b, frames * hop) and bool(torch.isfinite(wav).all())
        emit({"phase": "serving_bench_bf16_config", "config": name, "B": b, "frames": frames, "steps": 10, "cfg": 3.0,
              "wall_ms": wall * 1e3, "audio_s_per_s": b * frames * hop / sr / wall, "launches": counts,
              "expected_launches": expect, "card": card, "ok": ok})
        if not ok:
            fail(f"bf16 bench batch under {name}: launches {counts} vs {expect}, or bad output")
    return total


def phase_serving_solvers(api, card: str) -> None:
    """One f32 request per solver: finite output and the estimator calls it
    took (CFG is one [2B] call; each call runs the decoder's 6 blocks, and
    the text encoder's 3 run once): Euler 10, midpoint 20, rk4 40; for dopri5
    whatever its step control takes, with its accepted and rejected steps."""
    import stabletts_torch.models.sampler as sampler_mod

    ref = reference_wave(3)
    real_odeint = sampler_mod.odeint
    stats: dict = {}

    def odeint_with_stats(f, y0, t_span, method="euler", **kw):
        if method in sampler_mod.ADAPTIVE_SOLVERS:
            kw["stats"] = stats
        return real_odeint(f, y0, t_span, method=method, **kw)

    sampler_mod.odeint = odeint_with_stats
    try:
        for solver, calls in (("euler", 10), ("midpoint", 20), ("rk4", 40), ("dopri5", None)):
            stats.clear()
            reset_counts()
            t0 = time.time()
            wav, mel = api.inference(SENTENCES[0], ref, "english", step=10, cfg=3.0, solver=solver, seed=0)
            wall = time.time() - t0
            blocks = read_counts()["dit_block"]
            got_calls = (blocks - 3) / 6
            ok = bool(np.isfinite(wav).all() and np.isfinite(mel).all() and got_calls == int(got_calls)
                      and (got_calls == calls if calls is not None else got_calls == stats.get("f_evals")))
            emit({"phase": "serving_solver", "solver": solver, "estimator_calls": got_calls,
                  "expected_estimator_calls": calls, **({"ode": dict(stats)} if stats else {}),
                  "frames": int(mel.shape[2]), "wall_ms": wall * 1e3, "card": card, "ok": ok})
            if not ok:
                fail(f"serving_solver {solver}: {got_calls} estimator calls (expected {calls}, ode {stats})")
    finally:
        sampler_mod.odeint = real_odeint


def phase_serving_ffgan(dev, card: str) -> None:
    """One request through StableTTSAPI(vocoder_model_path=..., vocoder_name="ffgan")
    from a FireflyGAN state dict with random weights from a seed, written to
    a temporary directory: waveform length = frames * 512, finite, within
    [-1, 1]; then the FireflyGAN waveform on the GPU against the CPU for the
    same mel."""
    import copy

    from stabletts_torch.api import StableTTSAPI
    from stabletts_torch.models.ffgan import FireflyGANBase

    with torch.random.fork_rng(devices=[]), tempfile.TemporaryDirectory() as root:
        torch.manual_seed(1)
        path = os.path.join(root, "ffgan.pt")
        torch.save(FireflyGANBase(device="cpu").state_dict(), path)
        api = StableTTSAPI(vocoder_model_path=path, vocoder_name="ffgan", device=dev)
    if not isinstance(api.vocoder_model, FireflyGANBase):
        fail(f"serving_ffgan: the checkpoint loaded as {type(api.vocoder_model).__name__}")
    randomise(api.tts_model, seed=7)
    ref = reference_wave(3)
    api.inference(SENTENCES[0], ref, "english", step=10, cfg=3.0)  # warm
    torch.cuda.synchronize()
    t0 = time.time()
    wav, mel = api.inference(SENTENCES[0], ref, "english", step=10, cfg=3.0)
    wall = time.time() - t0
    mel_t = torch.from_numpy(np.ascontiguousarray(mel.transpose(0, 2, 1)))
    voc_ms = time_ms(lambda: api.vocoder_model(mel_t.to(dev)), iters=5)
    wav_gpu = api.vocoder_model(mel_t.to(dev)).cpu()
    wav_cpu = copy.deepcopy(api.vocoder_model).to("cpu")(mel_t)
    rel = rel_err(wav_gpu, wav_cpu)[0]
    ok = bool(wav.shape == (1, mel.shape[2] * 512) and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
              and rel <= 5e-3)
    emit({"phase": "serving_ffgan", "frames": int(mel.shape[2]), "samples": int(wav.shape[1]), "wall_ms": wall * 1e3,
          "vocoder_ms": voc_ms, "vocoder_params_M": api.get_params()[1], "wav_abs_max": float(np.abs(wav).max()),
          "gpu_vs_cpu_rel_err": rel, "bar": 5e-3, "card": card, "ok": ok})
    if not ok:
        fail(f"serving_ffgan: shape {wav.shape} for {mel.shape[2]} frames, GPU vs CPU rel err {rel}, or bad values")


def phase_profile(label: str, fn, card: str) -> None:
    """Device time by kernel and the device's busy share over one call of
    fn (torch.profiler, CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    # kernels only: the aten ops that launched them report the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:16]
    # device ms of common.cuh's kernels by family, all of their instantiations together
    families = {fam: sum(e.self_device_time_total for e in events if fam in e.key) / 1e3 for fam in PROFILE_FAMILIES}
    emit({"phase": f"profile_{label}", "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": max(0.0, 1.0 - busy_us / wall_us) if busy_us else None,
          "kernel_launches": sum(e.count for e in events), "families_device_ms": families,
          "top": [{"name": e.key[:100], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                  for e in top], "card": card})


def phase_gpu_vs_cpu(api, ref_wave) -> None:
    from stabletts_torch.api import StableTTSAPI

    cpu = StableTTSAPI(device="cpu")
    cpu.tts_model.load_state_dict({k: v.cpu() for k, v in api.tts_model.state_dict().items()})
    cpu.vocoder_model.load_state_dict({k: v.cpu() for k, v in api.vocoder_model.state_dict().items()})
    text = SENTENCES[1]
    wav_g, mel_g = api.inference(text, ref_wave, "english", step=10, cfg=3.0, seed=11)
    wav_c, mel_c = cpu.inference(text, ref_wave, "english", step=10, cfg=3.0, seed=11)
    row = {"phase": "gpu_vs_cpu", "frames_gpu": int(mel_g.shape[2]), "frames_cpu": int(mel_c.shape[2]),
           "bar": 5e-3, "ok": False}
    if mel_g.shape == mel_c.shape and wav_g.shape == wav_c.shape:
        row["mel_rel_err"] = float(np.abs(mel_g - mel_c).max() / np.abs(mel_c).max())
        row["wav_rel_err"] = float(np.abs(wav_g - wav_c).max() / np.abs(wav_c).max())
        row["ok"] = row["mel_rel_err"] <= 5e-3 and row["wav_rel_err"] <= 5e-3
    emit(row)
    if not row["ok"]:
        fail(f"GPU vs CPU end to end: {row}")


# --------------------------------------------------------------- training --


def train_counters():
    from stabletts_torch.ops import dit_attention_train_cuda as A
    from stabletts_torch.ops import ffn_train_cuda as F
    from stabletts_torch.ops.mas_cuda import mas

    return {"dit_attention_train_fwd": A.dit_attention_train_fwd, "dit_attention_train_bwd": A.dit_attention_train_bwd,
            "ffn_train_fwd": F.ffn_train_fwd, "ffn_train_bwd": F.ffn_train_bwd, "mas": mas}


def reset_train_counts():
    for fn in train_counters().values():
        fn.launches = 0


def read_train_counts() -> dict:
    return {name: fn.launches for name, fn in train_counters().items()}


def write_filelist(root: str, n: int = 96, seed: int = 0) -> str:
    """A synthetic training filelist: n random log-mels of 901-1000 frames x
    128 mels and phone lists of 120-190 symbols of the port's table."""
    from stabletts_torch.text import symbols

    rng = np.random.default_rng(seed)
    path = os.path.join(root, "filelist.jsonl")
    with open(path, "w") as f:
        for i in range(n):
            t = int(rng.integers(901, 1001))
            mel_path = os.path.join(root, f"mel_{i}.npy")
            np.save(mel_path, rng.standard_normal((t, 128)).astype(np.float32))
            phones = [symbols[k] for k in rng.integers(1, len(symbols), size=int(rng.integers(120, 191)))]
            f.write(json.dumps({"mel_path": mel_path, "phone": phones, "mel_length": t}) + "\n")
    return path


def phase_train_steps(dev, card: str, root: str) -> tuple:
    """train() at the flagship config: B=32, 2 epochs of 3 steps with a save
    per epoch, then a resume for a third epoch. Per step: losses, wall ms,
    training audio-s/s and the peak memory, and exactly 9/9/9/9/1 launches
    of the training kernels. Returns the launches over the whole run, the
    first step's loss and the steady steps' median wall ms (for `train_bf16`)."""
    from stabletts_torch.config import MelConfig, TrainConfig
    from stabletts_torch.train.train_tts import train

    mel = MelConfig()
    cfg = TrainConfig(train_dataset_path=write_filelist(root), batch_size=32, num_epochs=2,
                      model_save_path=os.path.join(root, "ckpt"), log_interval=1, save_interval=1,
                      loader_workers=2)
    audio_s = cfg.batch_size * 1000 * mel.hop_length / mel.sample_rate  # the bucket pads mels to 1000
    total = {k: 0 for k in TRAIN_LAUNCHES_PER_STEP}
    rows, last = [], [0.0]

    def log_fn(step, metrics):  # float metrics: the step has ended on the device
        now = time.time()
        wall, last[0] = now - last[0], now
        counts = read_train_counts()
        reset_train_counts()
        for k, v in counts.items():
            total[k] += v
        mem = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ok = counts == TRAIN_LAUNCHES_PER_STEP and all(math.isfinite(v) for v in metrics.values())
        rows.append({"phase": "train_step", "step": step, **metrics, "wall_ms": wall * 1e3,
                     "audio_s_per_s": audio_s / wall, "max_memory_allocated_GB": mem / 1e9, "launches": counts,
                     "card": card, "ok": ok})
        emit(rows[-1])

    reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    last[0] = time.time()
    first = train(cfg, log_fn=log_fn, device=dev)
    last[0] = time.time()
    resumed = train(dataclasses.replace(cfg, num_epochs=3), log_fn=log_fn, device=dev)
    steady = [r["wall_ms"] for r in rows[1:6]]
    ok = (all(r["ok"] for r in rows) and [r["step"] for r in rows] == list(range(9))
          and (first.step, first.start_epoch, resumed.start_epoch, resumed.step) == (6, 0, 2, 9))
    emit({"phase": "train_steps", "steps": len(rows), "first_run": [first.start_epoch, first.step],
          "resumed_run": [resumed.start_epoch, resumed.step], "launches": total,
          "steady_wall_ms_median": statistics.median(steady),
          "steady_audio_s_per_s": audio_s * 1e3 / statistics.median(steady),
          "card": card, "ok": ok})
    if not ok:
        fail(f"train_steps: launches, losses, step indices or the resume are wrong: {rows}")
    return total, rows[0]["loss"], statistics.median(steady)


def _train_batch(path: str, dev, b: int = 32):
    """One fixed batch of the synthetic filelist, padded as the trainer pads it."""
    from stabletts_torch.data.dataset import StableDataset, collate

    batch = collate(StableDataset(path), list(range(b)), 1000, 512, 128, (0, 0)).as_tuple()
    return tuple(torch.from_numpy(a).to(dev) for a in batch)


def phase_train_overfit(dev, card: str, root: str):
    """8 steps on one fixed B=32 batch at lr 1e-3: the loss must fall.
    Returns the step functions in f32 and in bf16, for the profiles."""
    from stabletts_torch.config import TrainConfig
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.train.scheduler import make_scheduler
    from stabletts_torch.train.train_tts import make_optimizer, train_step

    batch = _train_batch(os.path.join(root, "filelist.jsonl"), dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_stabletts(device=dev)
    model.train()
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=2)
    opt = make_optimizer(model, cfg)
    sched = make_scheduler(opt, cfg.learning_rate, cfg.warmup_steps, 100)
    gen = torch.Generator(device=dev)
    metrics = []
    for step in range(8):
        gen.manual_seed(1 + step)
        metrics.append({k: float(v) for k, v in train_step(model, opt, sched, batch, gen).items()})
    losses = [m["loss"] for m in metrics]
    ok = all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    emit({"phase": "train_overfit", "losses": losses,
          **{f"{k}es": [m[k] for m in metrics] for k in ("dur_loss", "diff_loss", "prior_loss")},
          "grad_norms": [m["grad_norm"] for m in metrics], "card": card, "ok": ok})
    if not ok:
        fail(f"train_overfit: the loss did not fall: {losses}")
    return lambda: train_step(model, opt, sched, batch, gen), \
        lambda: train_step(model, opt, sched, batch, gen, torch.bfloat16)


# one bf16 step against the f32 step on the same device, same weights and draws (rel). A single tensor's gradient
# (max-abs-err over the f32 tensor's max-abs) is bf16 rounding noise over its own size where the true sum cancels, so
# the kernels' path on the GPU is held, tensor by tensor, to a multiple of what the plain bf16 path on the CPU shows
# against f32: grad_gpu <= grad_ratio_to_cpu * (grad_cpu + grad_floor)
# Seen: loss 1.7e-3, gradient norm 5.9e-4, worst ratio 1.05 (1.14 under STABLETTS_ATTN_TRAIN=xla).
BF16_STEP_BARS = {"loss": 5e-3, "grad_norm": 5e-3, "grad_ratio_to_cpu": 3.0, "grad_floor": 0.02}


def phase_train_gpu_vs_cpu(dev) -> None:
    """One training step at the flagship width, B=2, 200 frames, dropout off,
    the same weights and CFG mask / t / noise on the GPU (kernels) and on the
    CPU (plain versions). y follows the model's own mu_x along known
    durations plus noise 0.1, so MAS has one clear optimum on both devices.
    Bars: the losses rel 1e-3, each gradient rel 2e-2 (max-abs-err /
    max-abs-cpu). A gradient that is zero in exact arithmetic (the key
    projections' biases: softmax ignores them) is f32 noise on both devices
    and is held to the noise level instead. Then `train_bf16_vs_f32`: the
    same step with compute_dtype bfloat16 on both devices, each against its
    f32 step, within BF16_STEP_BARS."""
    import copy

    from stabletts_torch.models import build_stabletts
    from stabletts_torch.train.train_tts import model_losses
    from stabletts_torch.ops.mask import sequence_mask

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        cpu_model = build_stabletts(device="cpu")
    randomise(cpu_model, seed=9)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(21)
    b, ty, tz = 2, 200, 64
    xl = np.asarray([60, 45])
    x = rng.integers(1, cpu_model.encoder.emb.num_embeddings, size=(b, 60)) * (np.arange(60)[None] < xl[:, None])
    z = rng.standard_normal((b, tz, 128)).astype(np.float32)
    zl = np.asarray([tz, 50])
    draws = {"cfg_mask": torch.tensor([[1.0], [0.0]]),
             "t_rand": torch.from_numpy(rng.uniform(size=b).astype(np.float32)),
             "noise": torch.from_numpy(rng.standard_normal((b, ty, 128)).astype(np.float32))}
    with torch.no_grad():
        zt, xt, xlt = torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(xl)
        c = cpu_model.ref_encoder(zt, sequence_mask(torch.from_numpy(zl), tz))
        c = c * draws["cfg_mask"] + (1 - draws["cfg_mask"]) * cpu_model.fake_speaker
        mu_x = cpu_model.encoder(xt, c, xlt)[1].numpy()
    yl = np.asarray([ty, 150])  # frames per item: each text token gets at least one
    durs = np.stack([np.pad(1 + rng.multinomial(yl[i] - xl[i], np.full(xl[i], 1.0 / xl[i])), (0, 60 - xl[i]))
                     for i in range(b)])
    y = np.zeros((b, ty, 128), np.float32)
    for i in range(b):
        y[i, :yl[i]] = np.repeat(mu_x[i], durs[i], axis=0) + 0.1 * rng.standard_normal((yl[i], 128))
    batch = [torch.from_numpy(a) for a in (x, xl, y, yl, z, zl)]

    out = {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")), ("gpu", gpu_model, dev)):
        model.train()
        losses = model(*(a.to(d) for a in batch), None, **{k: v.to(d) for k, v in draws.items()})
        sum(losses[:3]).backward()
        out[name] = ([float(v.detach()) for v in losses[:3]], losses[3].cpu(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()})
    (lc, ac, gc), (lg, ag, gg) = out["cpu"], out["gpu"]
    loss_rel = max(abs(u - v) / abs(v) for u, v in zip(lg, lc))
    # f32 rounding of sums over ~1e4 terms, relative to the model's largest gradient
    noise = 1e-5 * max(float(g.abs().max()) for g in gc.values())
    grad_rel, noise_only = {}, {}
    for k in gc:
        if k.endswith("attn.conv_k.bias"):  # zero in exact arithmetic
            noise_only[k] = max(float(gc[k].abs().max()), float(gg[k].abs().max()))
        else:
            grad_rel[k] = float((gg[k] - gc[k]).abs().max()) / max(float(gc[k].abs().max()), 1e-30)
    worst = max(grad_rel, key=grad_rel.get)
    row = {"phase": "train_gpu_vs_cpu", "B": b, "frames": int(yl.max()), "path_cells_differing": int((ag != ac).sum()),
           "losses_gpu": lg, "losses_cpu": lc, "loss_rel_err": loss_rel, "grad_rel_err_max": grad_rel[worst],
           "worst_grad": worst, "gradients_compared": len(grad_rel), "noise_only_gradients": len(noise_only),
           "noise_only_max_abs": max(noise_only.values(), default=0.0), "noise_level": noise,
           "bars": {"loss": 1e-3, "grad": 2e-2}}
    row["ok"] = (row["path_cells_differing"] == 0 and loss_rel <= 1e-3 and grad_rel[worst] <= 2e-2
                 and row["noise_only_max_abs"] <= noise)
    emit(row)
    if not row["ok"]:
        fail(f"training step, GPU vs CPU: {row}")

    # the same step in bf16: on the GPU (the training kernels' bf16 paths) and on the CPU (the plain versions, which
    # round where the kernels round), each against its device's f32 step
    bf = {}
    for name, model, d, (l32, a32, g32) in (("cpu", cpu_model, torch.device("cpu"), out["cpu"]),
                                             ("gpu", gpu_model, dev, out["gpu"])):
        model.zero_grad(set_to_none=True)
        t0 = time.time()
        losses = model_losses(model, [a.to(d) for a in batch], None, torch.bfloat16,
                              **{k: v.to(d) for k, v in draws.items()})
        sum(losses[:3]).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        norm = lambda gs: float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in gs.values()])))
        bf[name] = {"seconds": time.time() - t0, "losses": [float(v.detach()) for v in losses[:3]],
                    "cells": int((losses[3].cpu() != a32).sum()),
                    "f32": all(g.dtype == torch.float32 for g in grads.values()),
                    "norm_rel": abs(norm(grads) / norm(g32) - 1.0),
                    "grad_rel": {k: float((grads[k] - g32[k]).abs().max()) / max(float(g32[k].abs().max()), 1e-30)
                                 for k in grad_rel}}
        bf[name]["loss_rel"] = max(abs(u - v) / abs(v) for u, v in zip(bf[name]["losses"], l32))
    ratio = {k: e / (bf["cpu"]["grad_rel"][k] + BF16_STEP_BARS["grad_floor"]) for k, e in bf["gpu"]["grad_rel"].items()}
    worst = max(ratio, key=ratio.get)
    med = lambda name: statistics.median(bf[name]["grad_rel"].values())
    row = {"phase": "train_bf16_vs_f32", "B": b, "frames": int(yl.max()), "losses_bf16": bf["gpu"]["losses"],
           "losses_f32": lg, "path_cells_differing": bf["gpu"]["cells"], "loss_rel_err": bf["gpu"]["loss_rel"],
           "grad_norm_rel_err": bf["gpu"]["norm_rel"], "grad_rel_err_median": med("gpu"),
           "grad_rel_err_max": max(bf["gpu"]["grad_rel"].values()), "cpu_loss_rel_err": bf["cpu"]["loss_rel"],
           "cpu_grad_norm_rel_err": bf["cpu"]["norm_rel"], "cpu_grad_rel_err_median": med("cpu"),
           "cpu_grad_rel_err_max": max(bf["cpu"]["grad_rel"].values()), "cpu_path_cells_differing": bf["cpu"]["cells"],
           "gradients_compared": len(ratio), "worst_ratio_to_cpu": ratio[worst], "worst_grad": worst,
           "worst_grad_rel_errs_gpu_cpu": [bf["gpu"]["grad_rel"][worst], bf["cpu"]["grad_rel"][worst]],
           "gradients_f32": bf["gpu"]["f32"], "cpu_bf16_step_seconds": bf["cpu"]["seconds"], "bars": BF16_STEP_BARS}
    row["ok"] = bool(bf["gpu"]["f32"] and bf["gpu"]["cells"] == 0 and bf["gpu"]["loss_rel"] <= BF16_STEP_BARS["loss"]
                     and bf["gpu"]["norm_rel"] <= BF16_STEP_BARS["grad_norm"]
                     and ratio[worst] <= BF16_STEP_BARS["grad_ratio_to_cpu"])
    emit(row)
    if not row["ok"]:
        fail(f"training step, bf16 vs f32: {row}")


# ----------------------------------------- training configurations, bf16 --


def opt_in_counters():
    from stabletts_torch.ops import attention_train_cuda as A
    from stabletts_torch.ops import prenet_train_cuda as P

    return {**train_counters(), "attention_train_fwd": A.attention_train_fwd,
            "attention_train_bwd": A.attention_train_bwd, "prenet_train_fwd": P.prenet_train_fwd,
            "prenet_train_bwd": P.prenet_train_bwd}


TRAIN_VARIABLES = ("STABLETTS_ATTN_TRAIN", "STABLETTS_FFN_TRAIN", "STABLETTS_PRENET_TRAIN", "STABLETTS_ATTN_IMPL")
_NEW_ZERO = {"attention_train_fwd": 0, "attention_train_bwd": 0, "prenet_train_fwd": 0, "prenet_train_bwd": 0}
# the TTS trainer's configurations and the launches of one step under each
TRAIN_CONFIGS = {
    "default": ({}, {**TRAIN_LAUNCHES_PER_STEP, **_NEW_ZERO}),
    "attn_xla": ({"STABLETTS_ATTN_TRAIN": "xla"},
                 {**TRAIN_LAUNCHES_PER_STEP, **_NEW_ZERO, "dit_attention_train_fwd": 0, "dit_attention_train_bwd": 0,
                  "attention_train_fwd": 9, "attention_train_bwd": 9}),
    "prenet_fused": ({"STABLETTS_PRENET_TRAIN": "fused"},
                     {**TRAIN_LAUNCHES_PER_STEP, **_NEW_ZERO, "prenet_train_fwd": 1, "prenet_train_bwd": 1}),
    "attn_xla_prenet_fused": ({"STABLETTS_ATTN_TRAIN": "xla", "STABLETTS_PRENET_TRAIN": "fused"},
                              {**TRAIN_LAUNCHES_PER_STEP, "dit_attention_train_fwd": 0, "dit_attention_train_bwd": 0,
                               "attention_train_fwd": 9, "attention_train_bwd": 9, "prenet_train_fwd": 1,
                               "prenet_train_bwd": 1}),
}


@contextlib.contextmanager
def train_config(name: str):
    """The environment of one training configuration, restored on exit."""
    saved = {v: os.environ.pop(v, None) for v in TRAIN_VARIABLES}
    os.environ.update(TRAIN_CONFIGS[name][0])
    try:
        yield
    finally:
        for v, old in saved.items():
            os.environ.pop(v, None)
            if old is not None:
                os.environ[v] = old


def phase_train_configs(dev, card: str, root: str) -> dict:
    """One trainer batch (B=32, mels padded to 1000, f32) under each training
    configuration, from the same weights (seeded, adaLN randomised so every
    block matters). With dropout off and the same CFG mask, t and noise: the
    three losses within 1e-3 (rel) and every gradient within 2e-2
    (max-abs-err / max-abs) of the default configuration's. With dropout 0.1:
    three optimizer steps on a copy of the model, the launches of each
    training kernel per step held to the configuration's exact counts, the
    wall ms (median of the last two) and the peak memory. Returns the
    launches summed over the timed steps of all configurations."""
    from stabletts_torch.config import TrainConfig
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.train.scheduler import make_scheduler
    from stabletts_torch.train.train_tts import make_optimizer, model_losses, train_step

    batch = _train_batch(os.path.join(root, "filelist.jsonl"), dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_stabletts(device=dev)
    randomise(model, seed=9)
    model.train()
    rng = np.random.default_rng(31)
    b, ty = batch[2].shape[0], batch[2].shape[1]
    draws = {"cfg_mask": torch.from_numpy((rng.uniform(size=(b, 1)) > 0.2).astype(np.float32)).to(dev),
             "t_rand": torch.from_numpy(rng.uniform(size=b).astype(np.float32)).to(dev),
             "noise": torch.from_numpy(rng.standard_normal((b, ty, 128)).astype(np.float32)).to(dev)}
    audio_s = b * ty * 512 / 44100
    total = {k: 0 for k in opt_in_counters()}
    base = None
    for name, (env, expect) in TRAIN_CONFIGS.items():
        with train_config(name):
            model.zero_grad(set_to_none=True)
            dur, diff, prior, attn = model_losses(model, batch, None, None, **draws)
            (dur + diff + prior).backward()
            losses = [float(v.detach()) for v in (dur, diff, prior)]
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}
            model.zero_grad(set_to_none=True)
            if base is None:
                base = (losses, grads, attn)
            loss_rel = max(abs(u - v) / abs(v) for u, v in zip(losses, base[0]))
            grad_rel = {k: float((g - base[1][k]).abs().max()) / max(float(base[1][k].abs().max()), 1e-30)
                        for k, g in grads.items()}
            worst = max(grad_rel, key=grad_rel.get)
            cells = int((attn != base[2]).sum())
            del grads

            trained = copy.deepcopy(model)
            cfg = TrainConfig(learning_rate=1e-4, warmup_steps=2)
            opt = make_optimizer(trained, cfg)
            sched = make_scheduler(opt, cfg.learning_rate, cfg.warmup_steps, 100)
            gen = torch.Generator(device=dev)
            walls, counts_ok, counts, finite = [], True, {}, True
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for step in range(3):
                for fn in opt_in_counters().values():
                    fn.launches = 0
                gen.manual_seed(100 + step)
                t0 = time.time()
                metrics = {k: float(v) for k, v in train_step(trained, opt, sched, batch, gen).items()}
                walls.append(time.time() - t0)
                counts = {k: fn.launches for k, fn in opt_in_counters().items()}
                counts_ok = counts_ok and counts == expect
                finite = finite and all(math.isfinite(v) for v in metrics.values())
                for k, v in counts.items():
                    total[k] += v
            mem = torch.cuda.max_memory_allocated()
            del trained, opt, sched
            torch.cuda.empty_cache()
        wall = statistics.median(walls[1:])
        ok = bool(counts_ok and finite and loss_rel <= 1e-3 and grad_rel[worst] <= 2e-2)
        emit({"phase": "train_config", "config": name, "env": env, "B": b, "frames": ty, "wall_ms": wall * 1e3,
              "wall_ms_all": [w * 1e3 for w in walls], "audio_s_per_s": audio_s / wall,
              "max_memory_allocated_GB": mem / 1e9, "launches": counts, "expected_launches": expect,
              "losses_dropout_off": losses, "loss_rel_err_vs_default": loss_rel, "grad_rel_err_vs_default": grad_rel[worst],
              "worst_grad": worst, "path_cells_differing": cells, "bars": {"loss": 1e-3, "grad": 2e-2}, "loss": metrics["loss"],
              "card": card, "ok": ok})
        if not ok:
            fail(f"train_config {name}: launches {counts} vs {expect}, loss rel {loss_rel}, grad rel "
                 f"{grad_rel[worst]} at {worst}, or a loss that is not finite")
    return total


def phase_train_bf16(dev, card: str, root: str, f32_step0_loss: float, f32_wall_ms: float) -> dict:
    """`train()` with compute_dtype="bfloat16" on the same filelist and seed
    as `train_steps`: one epoch of 3 steps at B=32, the default configuration's
    launches per step, finite losses, f32 master parameters. The first
    step's loss is held to 0.1 (rel) of the f32 run's first step: the data
    and the weights are the same, the draws (made in bf16) are not. Then two
    bf16 steps of the trained model on one batch under
    STABLETTS_ATTN_TRAIN=xla, with that configuration's launches. Returns
    the launches of the training attention core's bf16 kernels over both
    runs ("_bf16" names)."""
    from stabletts_torch.config import TrainConfig
    from stabletts_torch.train.scheduler import make_scheduler
    from stabletts_torch.train.train_tts import make_optimizer, train, train_step

    cfg = TrainConfig(train_dataset_path=os.path.join(root, "filelist.jsonl"), batch_size=32, num_epochs=1,
                      model_save_path=os.path.join(root, "ckpt_bf16"), log_interval=1, save_interval=1,
                      loader_workers=2, compute_dtype="bfloat16")
    audio_s = cfg.batch_size * 1000 * 512 / 44100
    rows, last = [], [0.0]
    launches = {f"{k}_bf16": 0 for k in TRAIN_CORE_KERNELS}

    def log_fn(step, metrics):
        now = time.time()
        wall, last[0] = now - last[0], now
        counts = read_train_counts()
        reset_train_counts()
        for k in ("dit_attention_train_fwd", "dit_attention_train_bwd"):
            launches[f"{k}_bf16"] += counts[k]
        mem = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rows.append({"step": step, **metrics, "wall_ms": wall * 1e3, "max_memory_allocated_GB": mem / 1e9,
                     "launches": counts,
                     "ok": counts == TRAIN_LAUNCHES_PER_STEP and all(math.isfinite(v) for v in metrics.values())})

    reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    last[0] = time.time()
    state = train(cfg, log_fn=log_fn, device=dev)
    wall = statistics.median([r["wall_ms"] for r in rows[1:]])
    loss_rel = abs(rows[0]["loss"] - f32_step0_loss) / abs(f32_step0_loss)
    master_f32 = all(p.dtype == torch.float32 for p in state.model.parameters())
    ok = bool(all(r["ok"] for r in rows) and len(rows) == 3 and master_f32 and loss_rel <= 0.1)
    emit({"phase": "train_bf16", "steps": rows, "steady_wall_ms_median": wall, "steady_audio_s_per_s": audio_s * 1e3 / wall,
          "f32_steady_wall_ms_median": f32_wall_ms, "speedup_vs_f32": f32_wall_ms / wall,
          "first_loss": rows[0]["loss"], "f32_first_loss": f32_step0_loss, "first_loss_rel_err_vs_f32": loss_rel,
          "bar": 0.1, "master_parameters_f32": master_f32, "card": card, "ok": ok})
    if not ok:
        fail(f"train_bf16: {rows}, first loss rel err {loss_rel}")

    batch = _train_batch(cfg.train_dataset_path, dev)
    opt = make_optimizer(state.model, cfg)
    sched = make_scheduler(opt, cfg.learning_rate, cfg.warmup_steps, 100)
    gen = torch.Generator(device=dev)
    expect = TRAIN_CONFIGS["attn_xla"][1]
    xla_rows = []
    with train_config("attn_xla"):
        for step in range(2):
            for fn in opt_in_counters().values():
                fn.launches = 0
            gen.manual_seed(200 + step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            metrics = {k: float(v) for k, v in train_step(state.model, opt, sched, batch, gen, torch.bfloat16).items()}
            counts = {k: fn.launches for k, fn in opt_in_counters().items()}
            xla_rows.append({"step": step, **metrics, "wall_ms": (time.time() - t0) * 1e3,
                             "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
                             "ok": counts == expect and all(math.isfinite(v) for v in metrics.values())})
            for k in ("attention_train_fwd", "attention_train_bwd"):
                launches[f"{k}_bf16"] += counts[k]
    ok = all(r["ok"] for r in xla_rows)
    emit({"phase": "train_bf16_attn_xla", "env": TRAIN_CONFIGS["attn_xla"][0], "steps": xla_rows,
          "expected_launches": expect, "card": card, "ok": ok})
    if not ok:
        fail(f"train_bf16_attn_xla: {xla_rows}")
    return launches


# ------------------------------------------------------------ GAN training --


def write_wavs(root: str, count: int = 48, seconds: float = 1.0, sr: int = 44100, seed: int = 0) -> str:
    """A synthetic vocoder corpus: `count` 16-bit WAV files of a few harmonics
    with a slow envelope plus noise, from a numpy seed."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(count):
        f0 = rng.uniform(90, 320)
        wav = sum(rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) for h in range(1, 6))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)) + 0.02 * rng.standard_normal(t.size)
        wavfile.write(os.path.join(root, f"clip_{i:03d}.wav"), sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return root


def phase_gan(dev, card: str, root: str):
    """`train_vocos()` at the flagship Vocos (512 / 1536 / 8 layers), B=16,
    segment 20480, f32, on 48 one-second WAV files: one epoch of 3 steps with
    a checkpoint, then a resume for a second epoch (it must start at epoch 1,
    step 3). Per step: the 11 metrics (all finite), wall ms, segments/s,
    audio-s/s and the peak memory. Then one step in bf16 on the resumed state, and one
    f32 step with STABLETTS_ISTFT_IMPL=fused (one `istft_head` launch).
    Returns (the state, a real batch, the config) for the phases that follow."""
    from stabletts_torch.config import MelConfig, VocosTrainConfig
    from stabletts_torch.train.train_vocos import train_vocos, vocos_train_step

    cfg = VocosTrainConfig(train_dataset_path=write_wavs(os.path.join(root, "wavs")), model_save_path=os.path.join(
        root, "ckpt_vocos"), num_epochs=1, log_interval=1, save_interval=1, loader_workers=2, warmup_steps=2)
    audio_s = cfg.batch_size * cfg.segment_size / 44100
    rows, last = [], [0.0]

    def log_fn(step, metrics):  # float metrics: the step has ended on the device
        now = time.time()
        wall, last[0] = now - last[0], now
        mem = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ok = len(metrics) == 11 and all(math.isfinite(v) for v in metrics.values())
        rows.append({"phase": "gan_train_step", "step": step, **metrics, "wall_ms": wall * 1e3,
                     "segments_per_s": cfg.batch_size / wall, "audio_s_per_s": audio_s / wall,
                     "max_memory_allocated_GB": mem / 1e9, "card": card, "ok": ok})
        emit(rows[-1])

    torch.cuda.reset_peak_memory_stats()
    last[0] = time.time()
    first = train_vocos(cfg, log_fn=log_fn, device=dev)
    files = sorted(os.listdir(cfg.model_save_path))
    last[0] = time.time()
    resumed = train_vocos(dataclasses.replace(cfg, num_epochs=2), log_fn=log_fn, device=dev)
    steady = [r["wall_ms"] for r in rows[1:3] + rows[4:]]
    parts_ok = files == sorted(f"{p}_0.pt" for p in ("generator", "mpd", "mrd", "optimizerg", "optimizerd"))
    ok = (all(r["ok"] for r in rows) and [r["step"] for r in rows] == list(range(6)) and parts_ok
          and (first.start_epoch, first.step, resumed.start_epoch, resumed.step) == (0, 3, 1, 6)
          and resumed.sched_g.last_epoch == 6)
    wall = statistics.median(steady)
    emit({"phase": "gan_step", "B": cfg.batch_size, "segment": cfg.segment_size, "steps": len(rows),
          "first_run": [first.start_epoch, first.step], "resumed_run": [resumed.start_epoch, resumed.step],
          "checkpoint_files": files, "steady_wall_ms_median": wall, "steady_segments_per_s": cfg.batch_size * 1e3 / wall,
          "steady_audio_s_per_s": audio_s * 1e3 / wall,
          "max_memory_allocated_GB": max(r["max_memory_allocated_GB"] for r in rows),
          "generator_params_M": sum(p.numel() for p in resumed.gen.parameters()) / 1e6,
          "mpd_params_M": sum(p.numel() for p in resumed.mpd.parameters()) / 1e6,
          "mrd_params_M": sum(p.numel() for p in resumed.mrd.parameters()) / 1e6, "card": card, "ok": ok})
    if not ok:
        fail(f"gan_step: metrics, step indices, checkpoint files {files} or the resume are wrong: {rows}")

    from stabletts_torch.data.vocos_dataset import VocosDataset

    batch = VocosDataset(cfg.train_dataset_path, cfg.segment_size, 44100).batch(range(16), np.random.default_rng(1))
    audio = torch.from_numpy(batch).to(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    m = {k: float(v) for k, v in vocos_train_step(resumed, audio, MelConfig(), cfg.mel_loss_coeff, cfg.grad_clip,
                                                  torch.bfloat16).items()}
    wall = time.time() - t0
    masters = all(p.dtype == torch.float32 for mod in (resumed.gen, resumed.mpd, resumed.mrd) for p in mod.parameters())
    ok = all(math.isfinite(v) for v in m.values()) and masters
    emit({"phase": "gan_step_bf16", **m, "wall_ms_first_call": wall * 1e3, "master_parameters_f32": masters,
          "card": card, "ok": ok})
    if not ok:
        fail(f"gan_step_bf16: {m}")

    # one f32 step whose generator goes through the ISTFT kernel and its transposed backward
    from stabletts_torch.ops.istft_cuda import istft_head

    saved = os.environ.get("STABLETTS_ISTFT_IMPL")
    os.environ["STABLETTS_ISTFT_IMPL"] = "fused"
    try:
        istft_head.launches = 0
        m = {k: float(v) for k, v in vocos_train_step(resumed, audio, MelConfig(), cfg.mel_loss_coeff,
                                                      cfg.grad_clip).items()}
        launched = istft_head.launches
    finally:
        os.environ.pop("STABLETTS_ISTFT_IMPL")
        if saved is not None:
            os.environ["STABLETTS_ISTFT_IMPL"] = saved
    ok = launched == 1 and all(math.isfinite(v) for v in m.values())
    emit({"phase": "gan_step_istft_fused", **m, "launches_of_istft_head": launched, "card": card, "ok": ok})
    if not ok:
        fail(f"gan_step_istft_fused: {launched} istft_head launches, {m}")
    return resumed, audio, cfg


def vocos_step_for_profile(state, audio, cfg):
    from stabletts_torch.config import MelConfig
    from stabletts_torch.train.train_vocos import vocos_train_step

    return vocos_train_step(state, audio, MelConfig(), cfg.mel_loss_coeff, cfg.grad_clip)


def phase_mpd_in_gan(state, audio, card: str) -> int:
    """`mpd_stack` as a user scores audio with a trained MPD: on the
    trainer's own folded weights, a real batch and the generator's batch for
    its mels, five periods each (10 launches, counted from 0). Then those
    results against the trainer's `DiscriminatorP` on the same audio, max-abs
    2e-4. Returns the launches of the scoring run."""
    from stabletts_torch.config import MelConfig
    from stabletts_torch.ops.mpd_cuda import mpd_stack
    from stabletts_torch.ops.stft import log_mel_spectrogram

    with torch.no_grad():
        fake = state.gen(log_mel_spectrogram(audio, MelConfig()))
        folded = state.mpd.fold()
    mpd_stack.launches = 0
    t0 = time.time()
    scored = [[mpd_stack(x, f, d.period) for d, f in zip(state.mpd.discriminators, folded)] for x in (audio, fake)]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = mpd_stack.launches
    worst = 0.0
    with torch.no_grad():
        for x, outs in zip((audio, fake), scored):
            for d, f, (logits, fmap) in zip(state.mpd.discriminators, folded, outs):
                d_logits, d_fmap = d(x, f)
                worst = max(worst, *(float((a - r).abs().max()) for a, r in zip([logits, *fmap], [d_logits, *d_fmap])))
        real_score = float(sum(((1 - lo) ** 2).mean() for lo, _ in scored[0]))
        fake_score = float(sum((lo ** 2).mean() for lo, _ in scored[1]))
    ok = launches == 10 and worst <= MPD_BAR and math.isfinite(real_score + fake_score)
    emit({"phase": "mpd_in_gan", "launches": launches, "periods": [d.period for d in state.mpd.discriminators],
          "max_abs_err_vs_discriminator": worst, "bar": MPD_BAR, "disc_loss_mpd_from_kernel": real_score + fake_score,
          "wall_ms": wall * 1e3, "card": card, "ok": ok})
    if not ok:
        fail(f"mpd_in_gan: {launches} launches, max abs err {worst}")
    return launches


def phase_gan_gpu_vs_cpu(state, audio, cfg) -> None:
    """One GAN step on the GPU against the same step on the CPU
    (`device="cpu"`) from the same state (f32, the first 4 items of the
    batch): every loss within 1e-3 (rel), the gradient norms within 2e-2."""
    from stabletts_torch.config import MelConfig, VocosConfig
    from stabletts_torch.train.train_vocos import init_vocos_training, vocos_train_step

    out = {}
    for name, device in (("gpu", audio.device), ("cpu", torch.device("cpu"))):
        st = init_vocos_training(VocosConfig(), MelConfig(), cfg, 100, device=device)
        for mine, theirs in ((st.gen, state.gen), (st.mpd, state.mpd), (st.mrd, state.mrd)):
            mine.load_state_dict({k: v.to(device) for k, v in theirs.state_dict().items()})
        t0 = time.time()
        m = vocos_train_step(st, audio[:4].to(device), MelConfig(), cfg.mel_loss_coeff, cfg.grad_clip)
        out[name] = ({k: float(v) for k, v in m.items()}, time.time() - t0)
    (mg, tg), (mc, tc) = out["gpu"], out["cpu"]
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc}
    loss_rel = max(v for k, v in rel.items() if not k.startswith("grad_norm"))
    norm_rel = max(v for k, v in rel.items() if k.startswith("grad_norm"))
    ok = loss_rel <= 1e-3 and norm_rel <= 2e-2
    emit({"phase": "gan_gpu_vs_cpu", "B": 4, "metrics_gpu": mg, "metrics_cpu": mc, "loss_rel_err_max": loss_rel,
          "grad_norm_rel_err_max": norm_rel, "bars": {"loss": 1e-3, "grad_norm": 2e-2}, "wall_s_gpu": tg,
          "wall_s_cpu": tc, "ok": ok})
    if not ok:
        fail(f"GAN step, GPU vs CPU: {rel}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        from stabletts_torch.ops import _build
    except ImportError as e:
        fail(f"stabletts_torch is not importable here ({e}); run from the repository root")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    emit({"phase": "environment", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "card": card})

    t0 = time.time()
    _build.build_all()
    emit({"phase": "build", "seconds": time.time() - t0, "libraries": sorted(_build._libs)})
    phase_sass()
    phase_ptxas()

    bench = phase_kernels(dev)
    variant_rows, variant_launches = phase_attention_variants(dev)
    train_rows = phase_train_kernels(dev)
    train_rows.update(phase_opt_in_train_kernels(dev))
    api, counts, bench_pipeline = phase_serving(dev, card)
    # the host-clock phases come before the profiler's: once torch.profiler has
    # traced, every later launch costs the host more
    config_counts = phase_serving_configs(api, bench_pipeline, card)
    phase_serving_solvers(api, card)
    phase_serving_ffgan(dev, card)
    main_path_counts = [phase_serving_languages(api, card), phase_serving_ref_formats(api, card), phase_bench(card)]
    ref = reference_wave(5)
    phase_profile("request_f32", lambda: api.inference(SENTENCES[2], ref, "english", step=10, cfg=3.0), card)
    phase_profile("bench_bf16", bench_pipeline, card)
    phase_gpu_vs_cpu(api, reference_wave(3))
    # the default path's launches from its `inference` requests and the language,
    # reference-format and bench phases, the other DiT kernels' from the requests
    # of the configurations that run them
    counts = {k: (v + sum(c[k] for c in main_path_counts) if k in ("dit_block", "convnext", "istft")
                  else config_counts[k]) for k, v in counts.items()}
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the serving paths: {missing}")

    # host-clock training phases first, then the profiler's (see above)
    with tempfile.TemporaryDirectory() as root:
        train_counts, f32_first_loss, f32_wall_ms = phase_train_steps(dev, card, root)
        config_train_counts = phase_train_configs(dev, card, root)
        bf16_counts = phase_train_bf16(dev, card, root, f32_first_loss, f32_wall_ms)
        step_fn, step_fn_bf16 = phase_train_overfit(dev, card, root)
        gan_state, gan_audio, gan_cfg = phase_gan(dev, card, root)
    train_counts["mpd_stack"] = phase_mpd_in_gan(gan_state, gan_audio, card)
    phase_profile("train_step", step_fn, card)
    phase_profile("train_bf16", step_fn_bf16, card)
    phase_profile("gan_step", lambda: vocos_step_for_profile(gan_state, gan_audio, gan_cfg), card)
    phase_train_gpu_vs_cpu(dev)
    phase_gan_gpu_vs_cpu(gan_state, gan_audio, gan_cfg)
    # the opt-in kernels' launches come from the `train_config` runs that run them
    train_counts.update({k: v for k, v in config_train_counts.items() if k not in train_counts})
    train_counts.update(bf16_counts)
    missing = [k for k, v in train_counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the training paths: {missing}")

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = bench.get(name) or variant_rows.get(name) or train_rows[name]
        shape = {k: r[k] for k in ("B", "T", "Ty", "Tx", "dropout", "masked", "period") if k in r}
        step_name = name.removesuffix("_bf16")
        per_step = {"launches_per_step": TRAIN_LAUNCHES_PER_STEP[step_name]} if step_name in TRAIN_LAUNCHES_PER_STEP else {}
        if step_name in _NEW_ZERO:  # under the configuration that runs the kernel
            per_step = {"launches_per_step": TRAIN_CONFIGS["attn_xla_prenet_fused"][1][step_name]}
        if name in variant_launches and name != "attention_packed":
            per_step = {"launches_per_tool_run": variant_launches[name]}
            launched = sum(variant_launches[name].values())
        else:
            launched = counts[name] if name in counts else train_counts[name]
        if name in ADAPTERS:
            per_step["adapters"] = [{"entry": entry, "replaces": rep} for entry, rep in ADAPTERS[name]]
        if name == "attention_packed":
            per_step["launches_per_tool_run"] = variant_launches[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launched, **per_step,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": shape, "dtype": r["dtype"], "core": r.get("core"),
                        **{k: r[k] for k in ("projections", "wgrad") if k in r}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
