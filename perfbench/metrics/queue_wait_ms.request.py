"""The queue's wait before the server takes a request up (API, api.py: requests served
one at a time): the 90th percentile over the window's requests, ms, in an open-loop cell."""

from perfbench.lib.core import percentile


def read(ctx):
    waits = ctx["work"].get("waits_s")
    return 1e3 * percentile(waits, 90) if waits else None
