"""Roofline share of the DiT blocks (kernels, ops/dit_block_cuda): least time of the
blocks' math at the valid lengths over the device time inside their ranges."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, "dit_blocks")
