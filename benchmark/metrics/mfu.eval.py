"""The served forward's share of the configuration's peak (FlopCounterMode's
count of the reference's forward with cached 3D features)."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "serve")
