"""Device operations per request (sampler / host): kernels, copies and sets in the
traced window over the requests completed in it."""


def read(ctx):
    units = ctx["work"].get("units")
    return ctx["trace"]["ops"] / units if units else None
