"""RAFT-Stereo's forward's share of the configuration's peak:
FlopCounterMode's count over the reference's forward at the cell's batch,
frame size and iterations, times the window's pairs, over the window's
seconds."""
from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "serve")
