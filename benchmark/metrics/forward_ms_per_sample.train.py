"""Device ms per sample of a training step's `forward` stage and the refiner's
stages nested in it (towers, SuperPoint, refiner, losses): the median over
the stamped stretch's steps, over the batch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "train", "forward_ms_per_sample")
