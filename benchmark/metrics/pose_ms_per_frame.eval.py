"""Device ms per frame of the `pose` stage (per inner step the similarity
weight and the LM step): the median over the stamped stretch's requests,
over the batch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "serve", "pose_ms_per_frame")
