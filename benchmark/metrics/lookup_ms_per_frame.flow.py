"""Device ms per frame pair of the `lookup` stage of RAFT's forward: the
correlation lookups, summed over the iterations; the median over the stamped
stretch's requests of the stage's stamped time, over the batch."""
from benchmark import stages_flow


def read(ctx):
    return stages_flow.metric(ctx, "lookup_ms_per_frame")
