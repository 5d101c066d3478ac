"""The 95th percentile of every request of the window, in ms, from the
call to the host read of its pose (linear interpolation between order
statistics)."""
import numpy as np


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return float(np.percentile(ctx["latencies_ms"], 95))
