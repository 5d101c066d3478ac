"""Tensor ops: the raster kernels, sampling, correlation, upsampling,
nearest neighbours."""
