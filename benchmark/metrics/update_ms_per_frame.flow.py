"""Device ms per frame pair of the `update` stage of RAFT's forward: the update
block (motion encoder, SepConvGRU, flow head) and the coordinates' step,
summed over the iterations; the median over the stamped stretch's requests
of the stage's stamped time, over the batch."""
from benchmark import stages_flow


def read(ctx):
    return stages_flow.metric(ctx, "update_ms_per_frame")
