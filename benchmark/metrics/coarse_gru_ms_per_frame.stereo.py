"""Device ms per pair of the `coarse_gru` stage of RAFT-Stereo's forward: gru32
and gru16 on the 1/16 and 1/8 grids with their pooling and interpolation,
summed over the iterations; the median over the stamped stretch's requests of
the stage's stamped time, over the batch."""
from benchmark import stages_stereo


def read(ctx):
    return stages_stereo.metric(ctx, "coarse_gru_ms_per_frame")
