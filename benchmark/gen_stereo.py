"""Seeded rectified pairs of the stereo cells (RAFT-Stereo), frozen here so
that a change to the program cannot move them. Weights come from
`gen_flow.make_weights` (by name; the same rules serve RAFT-Stereo's
convolutions and batch norms).

* `make_pairs`: B rectified pairs (B, H, W, 3) in [0, 255]: a smooth random
  texture (three octaves of bilinearly upsampled noise, as `gen_flow`'s),
  the first frame (the left view) a crop of it and the second (the right
  view) the crop moved along the rows by a seeded whole-pixel disparity d in
  [0, `max_disp`] (image2 at x shows image1's texture at x + d: a point at x
  in image1 lies at x - d in image2, an x-flow of -d, as in a rectified rig),
  each frame with fresh Gaussian noise of std `noise` (in units of the 0-255
  range), drawn on the generator's device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["make_pairs"]


@torch.no_grad()
def make_pairs(batch: int, height: int, width: int, max_disp: int, noise: float,
               gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(image1, image2, disparity): frames (B, H, W, 3) f32 in [0, 255] on
    `gen`'s device, and each pair's disparity in pixels (B,)."""
    dev = gen.device
    tw = width + max_disp
    tex = torch.zeros(batch, 3, height, tw, device=dev)
    for cell, amp in ((64, 1.0), (16, 0.5), (4, 0.25)):
        low = torch.rand(batch, 3, height // cell + 2, tw // cell + 2, generator=gen, device=dev)
        tex += amp * F.interpolate(low, size=(height, tw), mode="bilinear", align_corners=False)
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    hi = tex.amax(dim=(1, 2, 3), keepdim=True)
    tex = 255.0 * (tex - lo) / (hi - lo)
    disp = torch.randint(0, max_disp + 1, (batch,), generator=gen, device=dev)
    img1 = tex[..., :width]
    img2 = torch.stack([tex[b, :, :, d:d + width] for b, d in enumerate(disp.tolist())])

    def noisy(img):
        n = torch.randn(img.shape, generator=gen, device=dev)
        return (img + noise * n).clamp(0.0, 255.0).permute(0, 2, 3, 1).contiguous()
    return noisy(img1), noisy(img2), disp
