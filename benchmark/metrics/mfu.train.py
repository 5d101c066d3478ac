"""The training step's share of the configuration's peak (FlopCounterMode's
count of the reference's forward and backward)."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "train")
