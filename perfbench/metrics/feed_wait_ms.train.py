"""Host milliseconds per training step that the trainer's thread waits for
its next batch (data, data/prefetch.py): the program's `data.wait` spans over
its `train.steps` counter."""

from perfbench.lib.spans import host_ms_per


def read(ctx):
    return host_ms_per(("data.wait",), "train.steps")
