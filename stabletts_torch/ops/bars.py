"""Each CUDA kernel's bar against its plain PyTorch version on the card.

A bar is the largest error allowed, relative to the largest magnitude of the
plain version's output (f32 / bf16). `chip_smoke.py` holds every kernel to
these bars, and the serving bench's gate (`stabletts_torch/tools/selftest.py`)
holds the three serving kernels to theirs; neither keeps a copy.
"""

from __future__ import annotations

import torch

BARS = {"dit_block": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "dit_attention": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "adaln_ffn": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        # tools/tpu_selftest.py:68 in bf16
        "attention_packed": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "attention_packed_t": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "convnext": {torch.float32: 2e-2, torch.bfloat16: 2e-2},
        "istft": {torch.float32: 1e-4, torch.bfloat16: 1e-3},
        # forward and every gradient (tools/tpu_selftest.py:96, 155, 209 in bf16)
        "ffn_train": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "dit_attention_train": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "attention_train": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        "prenet_train": {torch.float32: 5e-3, torch.bfloat16: 2e-2},
        # the bare tap GEMM: f32 sums in another order (bf16: the DiT block's bar)
        "tap_gemm": {torch.float32: 1e-4, torch.bfloat16: 2e-2},
        # the bare weight gradient and column sums: f32 sums of the same (bf16: exact) products in another order
        "wgrad": {torch.float32: 1e-4, torch.bfloat16: 1e-3},
        "colsum": {torch.float32: 1e-4, torch.bfloat16: 1e-4}}
VARIANT_KERNELS = ("attention_packed_v2", "attention_packed_rope", "attention_packed_kt",
                   "attention_decompose_matmul", "attention_decompose_nomax", "attention_decompose_bf16")
# the attention bar for every variant (tools/tpu_selftest.py:68); the matmul-only
# mode's error is relative to its own output's largest value like the others'
BARS.update({name: {torch.float32: 5e-3, torch.bfloat16: 2e-2} for name in VARIANT_KERNELS})
# #7's rotation (the first of its two launches): exact, each product and the sum rounded to the dtype as in its
# plain version
BARS["rope_packed"] = {torch.float32: 0.0, torch.bfloat16: 0.0}
