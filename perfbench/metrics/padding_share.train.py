"""Padding share of the stepped batches (data/sampler.py buckets): mel frames past each
item's length over all frames of the batches."""

from perfbench.lib.readers import padding_share


def read(ctx):
    return padding_share(ctx)
