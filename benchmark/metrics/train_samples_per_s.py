"""Samples stepped in the window over its seconds; the window closes on a
synchronise, so it holds all the work it launched."""
from benchmark import readers


def read(ctx):
    return readers.rate(ctx, "train")
