"""Device ms per sample of a training step's `update` stage (the norm, the
guard, DeviceAdam): the median over the stamped stretch's steps, over the
batch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "train", "update_ms_per_sample")
