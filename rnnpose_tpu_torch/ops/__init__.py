"""Tensor ops: sampling, correlation, upsampling,
nearest neighbours, furthest point sampling."""
from . import fps  # noqa: F401
