"""Roofline share of the vocoder (kernels: ConvNeXt #2, ISTFT head #3): least time of
the Vocos forward at the valid frames over the device time inside its range."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, "vocoder")
