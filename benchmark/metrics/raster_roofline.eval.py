"""The raster sweep's share of its roofline in a served request."""
from benchmark import readers


def read(ctx):
    return readers.raster_roofline(ctx, "serve")
