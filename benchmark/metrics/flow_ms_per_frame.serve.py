"""Device ms per frame of the `flow` stage (per inner step the pose-induced
coords, the correlation lookup and the GRU): the median over the stamped
stretch's requests, over the batch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "serve", "flow_ms_per_frame")
