"""Frames refined in the window over its seconds, in the reference-exact
evaluation cell (its own metric: its runs spread ~0.5%, the other serving
cells' ~6%, so it takes its own bound)."""
from benchmark import readers


def read(ctx):
    return readers.rate(ctx, "serve")
