"""Device ms per training sample of the traced steps."""
from benchmark import readers


def read(ctx):
    return readers.device_ms_per_unit(ctx, "train")
