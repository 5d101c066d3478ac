"""All-pairs correlation pyramid and windowed lookup, RAFT style (port of
`rnnpose_tpu/ops/corr.py`).

The volume is one f32 matmul per batch; the lookup gathers the four
bilinear taps of every window position directly (zero outside the level),
in the JAX package's separable order (rows first, then columns). A level
pooled to zero size (a 1/8 grid smaller than 2^(levels-1), e.g. 4 x 4 at 4
levels) reads 0, as the JAX package's empty sums do.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["CorrPyramid", "build_corr_pyramid", "corr_lookup"]


class CorrPyramid(NamedTuple):
    """levels[i] has shape (B, H*W, H/2^i, W/2^i)."""

    levels: Tuple[torch.Tensor, ...]


def _avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//2, W//2) mean; an odd last row/column is
    dropped (30 -> 15 -> 7)."""
    s = x.shape
    h2, w2 = s[-2] // 2, s[-1] // 2
    x = x[..., : h2 * 2, : w2 * 2].reshape(*s[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def build_corr_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4
) -> CorrPyramid:
    """fmap1, fmap2 (B, H, W, C) -> pyramid of (B, H*W, H/2^i, W/2^i) f32
    correlations scaled by 1/sqrt(C)."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).to(torch.float32)
    f2 = fmap2.reshape(B, H * W, C).to(torch.float32)
    # sqrt(C) rounded in the features' dtype, filled on their device (a copy
    # from the host would synchronise, which a CUDA graph capture refuses),
    # and divided by as a tensor: a host scalar divisor becomes a multiply
    # by its reciprocal on the card.
    scale = torch.full((), float(torch.tensor(C, dtype=fmap1.dtype).sqrt()),
                       dtype=torch.float32, device=f1.device)
    corr = (f1 @ f2.transpose(1, 2)) / scale
    levels = [corr.reshape(B, H * W, H, W)]
    for _ in range(num_levels - 1):
        levels.append(_avg_pool2x2(levels[-1]))
    return CorrPyramid(levels=tuple(levels))


def _taps(center: torch.Tensor, radius: int, size: int):
    """Window positions center + d, d in [-r, r] -> the two bilinear taps
    (lower index, weights, validity) along one axis, each (Q, win)."""
    d = torch.arange(-radius, radius + 1, dtype=center.dtype, device=center.device)
    pos = center[:, None] + d[None, :]
    i0 = torch.floor(pos)
    w1 = pos - i0
    w0 = 1.0 - w1
    i1 = i0 + 1
    v0 = (i0 >= 0) & (i0 <= size - 1)
    v1 = (i1 >= 0) & (i1 <= size - 1)
    # Out-of-range (and non-finite) taps index 0 with weight 0 (or NaN).
    zero = torch.zeros_like(i0)
    return (
        (torch.where(v0, i0, zero).long(), w0 * v0),
        (torch.where(v1, i1, zero).long(), w1 * v1),
    )


def corr_lookup(
    pyramid: CorrPyramid, coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """Sample a (2r+1)^2 window around coords/2^i at every level.

    coords (B, H, W, 2) at the 1/8 grid -> (B, H, W, L*(2r+1)^2),
    level-major, and within a level x-offset-major (dx-major, dy fastest),
    the reference's concat order that converted `convc1` weights need.
    """
    B, H, W, _ = coords.shape
    Q = B * H * W
    win = 2 * radius + 1
    cx = coords[..., 0].reshape(Q)
    cy = coords[..., 1].reshape(Q)
    outs = []
    for i, corr in enumerate(pyramid.levels):
        Hl, Wl = corr.shape[-2], corr.shape[-1]
        if Hl == 0 or Wl == 0:  # a level pooled away (a 1/8 grid under 2^i): all taps 0
            outs.append(torch.zeros((B, H, W, win * win), dtype=corr.dtype,
                                    device=corr.device))
            continue
        scale = 1.0 / (2.0 ** i)
        ty = _taps(cy * scale, radius, Hl)                     # over dy
        tx = _taps(cx * scale, radius, Wl)                     # over dx
        vol = corr.reshape(Q, Hl * Wl)
        out = 0.0
        for xi, wx in tx:                                      # (Q, win)
            col = 0.0
            for yi, wy in ty:
                idx = yi[:, None, :] * Wl + xi[:, :, None]     # (Q, dx, dy)
                v = torch.gather(vol, 1, idx.reshape(Q, -1)).reshape(Q, win, win)
                col = col + wy[:, None, :] * v
            out = out + wx[:, :, None] * col
        outs.append(out.reshape(B, H, W, win * win))
    return torch.cat(outs, dim=-1)
