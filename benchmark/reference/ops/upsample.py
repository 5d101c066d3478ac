"""Flow upsampling ops (port of `rnnpose_tpu/ops/upsample.py`): RAFT's
learned convex 8x upsampling and the fixed-stencil bilinear 2x upsampling.
Plain torch ops: the JAX package computes both in XLA, outside any Pallas
kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["unfold3x3", "convex_upsample", "upflow", "upsample2x_bilinear"]


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 patches: (B, H, W, C) -> (B, H, W, 9, C), taps in
    row-major (dy, dx) order."""
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack(
        [xp[:, dy:dy + H, dx:dx + W, :] for dy in range(3) for dx in range(3)],
        dim=-2,
    )


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Learned convex upsampling of a coarse flow (B, H, W, 2) with the
    unnormalised logits mask (B, H, W, 9 * factor * factor), laid out
    (9, factor, factor) per coarse pixel; softmax over the 9 taps. Returns
    (B, H * factor, W * factor, 2), scaled by `factor`."""
    B, H, W, _ = flow.shape
    f = factor
    m = torch.softmax(mask.reshape(B, H, W, 9, f, f), dim=3)
    patches = unfold3x3(flow * f)                              # (B, H, W, 9, 2)
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", m, patches)     # (B, H, W, f, f, 2)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, H * f, W * f, 2)


def upflow(flow: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """Bilinear flow upsampling (B, H, W, C) -> (B, H*f, W*f, C), the
    magnitude scaled by f (half-pixel centres, edges clamped: the JAX
    package's `jax.image.resize(..., "bilinear")`)."""
    out = F.interpolate(flow.movedim(-1, 1), scale_factor=factor, mode="bilinear",
                        align_corners=False)
    return out.movedim(1, -1) * factor


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
