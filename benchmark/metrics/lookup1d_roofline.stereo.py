"""% of the 1D correlation lookup kernel's roofline: its bytes
(`runners/stereo.lookup1d_bytes`: each query's x, the 2r+2 values of its
row a level, its outputs) at 3.35 TB/s over its device time a launch in the
traced requests."""
from benchmark.runners import stereo


def read(ctx):
    return stereo.lookup1d_roofline(ctx)
