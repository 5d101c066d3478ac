"""Device ms per pair of the `lookup` stage of RAFT-Stereo's forward: the 1D
correlation lookups, summed over the iterations; the median over the stamped
stretch's requests of the stage's stamped time, over the batch."""
from benchmark import stages_stereo


def read(ctx):
    return stages_stereo.metric(ctx, "lookup_ms_per_frame")
