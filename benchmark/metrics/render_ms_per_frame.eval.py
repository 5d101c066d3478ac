"""Device ms per frame of the `render` stage (per render iteration the pose,
the zoom crop, the raster, the attribute and feature interpolation and the
shading): the median over the stamped stretch's requests, over the batch."""
from benchmark import stages


def read(ctx):
    return stages.metric(ctx, "serve", "render_ms_per_frame")
