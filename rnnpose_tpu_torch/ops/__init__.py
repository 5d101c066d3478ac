"""Tensor ops: the raster kernel, sampling, correlation, upsampling."""
