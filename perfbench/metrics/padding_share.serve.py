"""Padding share of the estimator (sampler, models/sampler.py): estimator frames past
each item's length over all estimator frames of the window."""

from perfbench.lib.readers import padding_share


def read(ctx):
    return padding_share(ctx)
