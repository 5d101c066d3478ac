"""Device ms per frame of the `encode` stage (SuperPoint; per render iteration the
crop resample, the RAFT encoder on both crops, the correlation pyramid, the
context split and the descriptor crop): the median over the stamped
stretch's requests of the stage's stamped time, over the batch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "serve", "encode_ms_per_frame")
