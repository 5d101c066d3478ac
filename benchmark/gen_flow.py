"""Seeded weights and frame pairs of the flow cells (RAFT), frozen here so
that a change to the program cannot move them.

* `make_weights`: a RAFT `state_dict` by name (the program's module tree
  and the reference's name their parameters and buffers alike), drawn on
  the device in one call: every convolution's weight normal with std
  1/sqrt(fan_in) and its bias a tenth of that; a batch norm's weight 1 +
  0.1 n, its bias and running mean 0.1 n, its running variance exp(0.2 n),
  so that the context encoder's norms are neither the identity nor alike.
* `make_pairs`: B frame pairs (B, H, W, 3) in [0, 255]: a smooth random
  texture (three octaves of bilinearly upsampled noise), the first frame a
  crop of it and the second the crop moved by a seeded whole-pixel
  translation of up to `max_shift` pixels on each axis, each frame with
  fresh uniform noise `noise` wide (in units of the 0-255 range).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["make_weights", "make_pairs"]


@torch.no_grad()
def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every entry of `model.state_dict()` (see the
    module docstring), on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    state = model.state_dict()
    # By name, so that module trees that register alike names in another
    # order draw the same weights.
    floats = [(n, state[n]) for n in sorted(state) if state[n].is_floating_point()]
    noise = torch.randn(sum(t.numel() for _, t in floats), generator=gen, device=device)
    fan = {n.rsplit(".", 1)[0]: t[0].numel() for n, t in floats if t.dim() == 4}
    out, at = {}, 0
    for name, t in floats:
        n = noise[at:at + t.numel()].view(t.shape)
        at += t.numel()
        module, leaf = name.rsplit(".", 1)
        if module in fan:  # a convolution's weight or bias
            std = fan[module] ** -0.5
            out[name] = n * (std if leaf == "weight" else 0.1 * std)
        elif leaf == "weight":
            out[name] = 1.0 + 0.1 * n
        elif leaf == "running_var":
            out[name] = torch.exp(0.2 * n)
        else:  # a norm's bias or running mean
            out[name] = 0.1 * n
    for name, t in state.items():
        if name not in out:  # num_batches_tracked
            out[name] = torch.zeros_like(t, device=device)
    return out


@torch.no_grad()
def make_pairs(batch: int, height: int, width: int, max_shift: int, noise: float,
               gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(image1, image2, shift): frames (B, H, W, 3) f32 in [0, 255] on
    `gen`'s device, and the (dx, dy) pixel translation of each pair (B, 2)
    (image2 at (x, y) shows image1's texture at (x + dx, y + dy))."""
    dev = gen.device
    m = max_shift
    th, tw = height + 2 * m, width + 2 * m
    tex = torch.zeros(batch, 3, th, tw, device=dev)
    for cell, amp in ((64, 1.0), (16, 0.5), (4, 0.25)):
        low = torch.rand(batch, 3, th // cell + 2, tw // cell + 2, generator=gen, device=dev)
        tex += amp * F.interpolate(low, size=(th, tw), mode="bilinear", align_corners=False)
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    hi = tex.amax(dim=(1, 2, 3), keepdim=True)
    tex = 255.0 * (tex - lo) / (hi - lo)
    shift = torch.randint(-m, m + 1, (batch, 2), generator=gen, device=dev)
    sh = shift.tolist()
    img1 = tex[:, :, m:m + height, m:m + width]
    img2 = torch.stack([tex[b, :, m + dy:m + dy + height, m + dx:m + dx + width]
                        for b, (dx, dy) in enumerate(sh)])

    def noisy(img):
        n = torch.rand(img.shape, generator=gen, device=dev) - 0.5
        return (img + noise * n).clamp(0.0, 255.0).permute(0, 2, 3, 1).contiguous()
    return noisy(img1), noisy(img2), shift
