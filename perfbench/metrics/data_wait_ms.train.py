"""Host milliseconds per step spent waiting for the next batch from the data layer
(data/prefetch.py): the time in the feed's next() over the steps of the window."""


def read(ctx):
    w = ctx["work"]
    return 1e3 * w["wait_s"] / w["units"] if w.get("units") else None
