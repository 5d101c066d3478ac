"""Device ms per pair of the `encode` stage of RAFT-Stereo's forward: the pad,
the normalisation, `fnet` on both frames at full resolution, `cnet` on the
first and the context convolutions; the median over the stamped stretch's
requests of the stage's stamped time, over the batch."""
from benchmark import stages_stereo


def read(ctx):
    return stages_stereo.metric(ctx, "encode_ms_per_frame")
