"""Device ms per frame pair of the `corr` stage of RAFT's forward: the all-
pairs correlation pyramid (one f32 matmul and three 2x2 poolings); the
median over the stamped stretch's requests of the stage's stamped time, over
the batch."""
from benchmark import stages_flow


def read(ctx):
    return stages_flow.metric(ctx, "corr_ms_per_frame")
