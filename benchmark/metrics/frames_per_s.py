"""Frames refined in the window over its seconds (serving cells)."""
from benchmark import readers


def read(ctx):
    return readers.rate(ctx, "serve")
