"""Operations and bytes that FireflyGAN needs for mels of given lengths,
counted from the configuration's `vocoder` widths, whatever implements the
layers: padding past an item's length is not counted. A multiply-add is two
operations; the products are the convolutions, the transposed convolutions
and the ConvNeXt blocks' linears (norms, activations and sums are left out).
Bytes: the weights read once, each mel read once and each waveform written
once, in the cell's compute type.

At the published widths a mel frame costs 693,243,904 operations:
38,719,488 in the ConvNeXt encoder and 654,524,416 in the HiFiGAN head.
"""

from __future__ import annotations

import math

from perfbench.counts.peaks import DTYPE_BYTES, least_seconds
from perfbench.reference.ffgan_ref import parameter_shapes


def backbone_flops_per_frame(v: dict) -> float:
    b = v["backbone"]
    k, dims = b["kernel_size"], b["dims"]
    flops = 2 * k * b["input_channels"] * dims[0]
    flops += sum(2 * dims[i - 1] * dims[i] for i in range(1, len(dims)))
    flops += sum(depth * (2 * k * d + 2 * 2 * d * 4 * d) for depth, d in zip(b["depths"], dims))
    return float(flops)


def head_flops_per_frame(v: dict) -> float:
    """conv_pre, then at each stage the transposed conv (every input position
    times k taps) and three ResBlocks of pairs of convs at the upsampled rate,
    then conv_post at the waveform's rate."""
    h = v["head"]
    ch, rate = h["upsample_initial_channel"], 1
    flops = 2 * h["pre_conv_kernel_size"] * h["num_mels"] * ch
    res_taps = sum(2 * k * len(d) for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
    for u, k in zip(h["upsample_rates"], h["upsample_kernel_sizes"]):
        flops += rate * 2 * k * ch * (ch // 2)
        ch, rate = ch // 2, rate * u
        flops += rate * 2 * res_taps * ch * ch
    flops += rate * 2 * h["post_conv_kernel_size"] * ch
    return float(flops)


def flops_per_frame(v: dict) -> float:
    return backbone_flops_per_frame(v) + head_flops_per_frame(v)


def vocoder_call(v: dict, lengths, dtype: str) -> tuple:
    """(operations, bytes) of one FireflyGAN forward over mels of `lengths`
    frames."""
    b = DTYPE_BYTES[dtype]
    frames = float(sum(lengths))
    weights = sum(math.prod(s) for s in parameter_shapes(v).values()) * b
    per_frame_io = (v["backbone"]["input_channels"] + math.prod(v["head"]["upsample_rates"])) * b
    return frames * flops_per_frame(v), weights + frames * per_frame_io


def vocoder_least_s(v: dict, lengths, dtype: str) -> float:
    return least_seconds(*vocoder_call(v, lengths, dtype), dtype)
