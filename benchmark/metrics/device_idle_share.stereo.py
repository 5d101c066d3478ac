"""The device's idle share of the stereo window: the gaps between calls, by
CUDA events."""
from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
