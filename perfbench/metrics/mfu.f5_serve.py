"""Model FLOP utilisation of F5-TTS batch serving (model step, models/): the
operations the items need at their valid frames (counts/f5tts.py: text
blocks, input embedding, the 22 blocks x 32 steps x 2 rows, the final layer
and the vocoder) over the window and the peak of the compute type
(counts/peaks.py)."""

from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx)
