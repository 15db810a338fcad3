"""Roofline share of F5-TTS's DiT blocks (kernels, ops/dit_block_cuda): least
time of the blocks' math at the valid frames (counts/f5tts.py) over the
device time inside their ranges (`trace_modules` "f5_blocks")."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, "f5_blocks")
