"""Device ms per stereo pair of the traced requests: the summed own time of
their kernel, memcpy and memset events over their pairs."""
from benchmark import readers


def read(ctx):
    return readers.device_ms_per_unit(ctx, "serve")
