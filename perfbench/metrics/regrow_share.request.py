"""Share of requests that the API synthesised again at a doubled mel cap (api.py),
counted from the API logger's regrow records."""


def read(ctx):
    w = ctx["work"]
    return 100.0 * w["regrown"] / w["units"] if w.get("units") else None
