"""Device ms per refined frame of the traced requests: the summed own time
of their kernel, memcpy and memset events over their frames."""
from benchmark import readers


def read(ctx):
    return readers.device_ms_per_unit(ctx, "serve")
