"""Mean host ms of one `Trainer.run_step` call in the window (copy-in,
replay A, the eager all-reduce, replay B, clones)."""
from benchmark import readers


def read(ctx):
    return readers.host_ms(ctx, "train")
