"""Host milliseconds per request in the API's front end (api.py): the
program's `api.g2p` and `api.ref_mel` spans over its `api.requests` counter."""

from perfbench.lib.spans import host_ms_per


def read(ctx):
    return host_ms_per(("api.g2p", "api.ref_mel"), "api.requests")
