"""Roofline share of FireflyGAN (model step, models/ffgan.py): the least time
of its operations and bytes at the valid frames (counts/ffgan.py) over the
device time inside the harness's ranges on its backbone and head
(`trace_modules` "ffgan"), which the program opens no span inside."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, "ffgan")
