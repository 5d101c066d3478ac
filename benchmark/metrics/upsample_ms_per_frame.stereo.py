"""Device ms per pair of the `upsample` stage of RAFT-Stereo's forward: the
mask head, the convex 4x upsampling and the unpad; the median over the stamped
stretch's requests of the stage's stamped time, over the batch."""
from benchmark import stages_stereo


def read(ctx):
    return stages_stereo.metric(ctx, "upsample_ms_per_frame")
