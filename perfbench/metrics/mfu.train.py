"""Model FLOP utilisation of training (train step, train/train_tts.py): three times the
forward operations of the stepped batches at their valid lengths (forward and
backward) over the window and the float32 peak."""

from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
