"""Device ms per frame pair of the `upsample` stage of RAFT's forward: the mask
head, the convex 8x upsampling and the unpad; the median over the stamped
stretch's requests of the stage's stamped time, over the batch."""
from benchmark import stages_flow


def read(ctx):
    return stages_flow.metric(ctx, "upsample_ms_per_frame")
