"""The device's idle share of the serving window."""
from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
