"""Fixed-stencil bilinear 2x upsampling (port of
`rnnpose_tpu/ops/upsample.py::upsample2x_bilinear`). The learned convex
upsampling comes with the training path."""
from __future__ import annotations

import torch

__all__ = ["upsample2x_bilinear"]


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2H, 2W, C), equal to half-pixel bilinear resize:
    even outputs 0.25 prev + 0.75 cur, odd 0.75 cur + 0.25 next, edges
    clamped."""

    def up(a, dim):
        n = a.shape[dim]
        prev = torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim)
        even = 0.25 * prev + 0.75 * a
        odd = 0.75 * a + 0.25 * nxt
        out = torch.stack([even, odd], dim=dim + 1)
        return out.reshape(a.shape[:dim] + (2 * n,) + a.shape[dim + 1:])

    return up(up(x, 1), 2)
