"""Point-splat depth rendering (foreground masks): port of
`rnnpose_tpu/render/splat.py`.

The reference's `render_pointcloud` (`geometry/diff_render_optim.py:369-402`):
a vertex scatter used for foreground masks and zoom-crop boxes, not on the
gradient path (the reference detaches it too). Each vertex writes its depth
to a (2r+1)^2 footprint around its rounded pixel with a scatter-min
(`scatter_reduce(..., "amin")`, the JAX package's `.at[...].min`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..geometry import projective as proj

__all__ = ["splat_depth", "splat_mask"]

_FAR = 1e6


@torch.no_grad()
def splat_depth(
    verts_cam: torch.Tensor,
    intrinsics: torch.Tensor,
    h: int,
    w: int,
    valid: Optional[torch.Tensor] = None,
    radius: int = 1,
) -> torch.Tensor:
    """Splat camera-frame vertices into a depth map.

    Args:
      verts_cam: (B, V, 3) vertices in the camera frame.
      intrinsics: (B, 4).
      h, w: output size.
      valid: optional (B, V) mask for padded vertices.
      radius: splat half-size in pixels (each vertex covers a (2r+1)^2
        footprint, closing small holes like the reference's point-radius
        rasterization).
    Returns:
      (B, h, w) depth map, 0 where nothing splatted.
    """
    uv, _ = proj.project(verts_cam, intrinsics[:, None, :])
    z = verts_cam[..., 2]
    ok = z > proj.MIN_DEPTH
    if valid is not None:
        ok = ok & (valid > 0)
    x = torch.round(uv[..., 0]).to(torch.int64)   # half to even, as jnp.round
    y = torch.round(uv[..., 1]).to(torch.int64)
    buf = torch.full((z.shape[0], h * w), _FAR, dtype=z.dtype, device=z.device)
    far = torch.full_like(z, _FAR)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            xs, ys = x + dx, y + dy
            inside = ok & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
            idx = torch.where(inside, ys * w + xs, torch.zeros_like(xs))
            buf.scatter_reduce_(1, idx, torch.where(inside, z, far), "amin")
    buf = buf.reshape(-1, h, w)
    return torch.where(buf < _FAR, buf, torch.zeros_like(buf))


def splat_mask(
    verts_cam: torch.Tensor,
    intrinsics: torch.Tensor,
    h: int,
    w: int,
    valid: Optional[torch.Tensor] = None,
    radius: int = 1,
) -> torch.Tensor:
    """Foreground mask from the splatted depth (depth > 0)."""
    d = splat_depth(verts_cam, intrinsics, h, w, valid, radius)
    return (d > 0).to(verts_cam.dtype)
