"""Mean host ms of one `InferenceEngine.refine` call in the window (copy-in,
replay, clones), from the benchmark's span around the call."""
from benchmark import readers


def read(ctx):
    return readers.host_ms(ctx, "serve")
