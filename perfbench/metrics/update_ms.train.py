"""Host milliseconds per training step in the update (train step,
train/train_tts.py): the program's `train.update` spans (the gradient fill,
the gradient norm, AdamW and the schedule) over its `train.steps` counter."""

from perfbench.lib.spans import host_ms_per


def read(ctx):
    return host_ms_per(("train.update",), "train.steps")
