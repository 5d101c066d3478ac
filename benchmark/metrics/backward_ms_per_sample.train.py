"""Device ms per sample of a training step's `backward` stage (the backward,
the zero fill, the metric copies): the median over the stamped stretch's
steps, over the batch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "train", "backward_ms_per_sample")
