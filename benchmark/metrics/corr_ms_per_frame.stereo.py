"""Device ms per pair of the `corr` stage of RAFT-Stereo's forward: the 1D
correlation volume (one batched f32 matmul over the image rows) and its three
poolings along the row; the median over the stamped stretch's requests of the
stage's stamped time, over the batch."""
from benchmark import stages_stereo


def read(ctx):
    return stages_stereo.metric(ctx, "corr_ms_per_frame")
