"""Bilinear sampling with zero padding, channel-last (port of
`rnnpose_tpu/ops/sampler.py`).

`coords` are pixel coordinates (x, y); taps outside the image contribute 0
(the reference's `grid_sample(padding_mode='zeros')`). Non-finite coords
give non-finite samples, never an out-of-range index.
"""
from __future__ import annotations

import torch

from ..geometry.crop import crop_source_coords
from ..geometry.precise import fma

__all__ = ["bilinear_sample", "bilinear_sample_nchw", "separable_crop_sample"]


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """image (B, H, W, C), coords (B, ..., 2) -> (B, ..., C)."""
    B, H, W, C = image.shape
    out_shape = coords.shape[:-1] + (C,)
    coords = coords.reshape(B, -1, 2)
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None].to(image.dtype)
    wy = (y - y0)[..., None].to(image.dtype)
    flat = image.reshape(B, H * W, C)

    def gather(xi, yi):
        # Out-of-range and non-finite taps read row 0 and are zeroed.
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = torch.where(valid, yi * W + xi, torch.zeros_like(xi)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        return vals * valid[..., None].to(image.dtype)

    # The four taps' sum rounds as XLA rounds the JAX package's
    # `v00 (1-wx)(1-wy) + v01 wx (1-wy) + v10 (1-wx) wy + v11 wx wy`: the
    # first product is contracted into the second term's add, and each
    # later product into its add (`precise.fma`).
    out = fma(gather(x0, y0) * (1 - wx), 1 - wy, gather(x0 + 1, y0) * wx * (1 - wy))
    out = fma(gather(x0, y0 + 1) * (1 - wx), wy, out)
    out = fma(gather(x0 + 1, y0 + 1) * wx, wy, out)
    return out.reshape(out_shape)


def bilinear_sample_nchw(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """NCHW form: image (B, C, H, W), coords (B, H', W', 2) -> (B, C, H', W')."""
    return bilinear_sample(image.movedim(1, -1), coords).movedim(-1, 1)


def separable_crop_sample(
    image: torch.Tensor, crop_params: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Axis-aligned zoom-crop resample: image (B, H, W, C), crop_params
    (B, 4) [cx, cy, half_x, half_y] -> (B, S, S, C), equal to
    `bilinear_sample(image, crop_source_coords(crop_params, S))`, which is
    how it is computed here (a gather suits the GPU)."""
    return bilinear_sample(image, crop_source_coords(crop_params, out_size))
