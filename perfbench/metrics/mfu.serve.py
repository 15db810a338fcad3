"""Model FLOP utilisation of batch serving (model step, models/): the operations the
items need at their valid lengths (counts/stabletts.py) over the window and the
peak of the compute type (counts/peaks.py)."""

from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
