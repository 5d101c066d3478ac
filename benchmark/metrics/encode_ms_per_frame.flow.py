"""Device ms per frame pair of the `encode` stage of RAFT's forward: the pad,
the normalisation and both encoders (`fnet` on both frames, `cnet` on the
first) with the context split; the median over the stamped stretch's
requests of the stage's stamped time, over the batch."""
from benchmark import stages_flow


def read(ctx):
    return stages_flow.metric(ctx, "encode_ms_per_frame")
