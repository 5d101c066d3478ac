"""Device ms per pair of the `update` stage of RAFT-Stereo's forward: the
motion encoder, gru08 on the 1/4 grid, the flow head and the coordinates' step,
summed over the iterations; the median over the stamped stretch's requests of
the stage's stamped time, over the batch."""
from benchmark import stages_stereo


def read(ctx):
    return stages_stereo.metric(ctx, "update_ms_per_frame")
