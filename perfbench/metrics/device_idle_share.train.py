"""Device idle share of the training window (device layer): 100 x (1 - busy / window)."""

from perfbench.lib.readers import idle_share


def read(ctx):
    return idle_share(ctx)
