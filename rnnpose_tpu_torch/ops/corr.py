"""All-pairs correlation pyramid and windowed lookup, RAFT style (port of
`rnnpose_tpu/ops/corr.py`), and RAFT-Stereo's 1D pyramid along image rows
with its lookup (`build_corr_pyramid_1d`, `corr_lookup_1d`).

The volume is one f32 matmul per batch. The lookup gathers the four
bilinear taps of every window position directly (zero outside the level),
in the JAX package's separable order (rows first, then columns). A level
pooled to zero size (a 1/8 grid smaller than 2^(levels-1), e.g. 4 x 4 at 4
levels) reads 0, as the JAX package's empty sums do. Where no gradient is
needed (eval and serving run under `torch.no_grad()`) the lookup is one call
of the operator `kernels/corr.corr_lookup`: one kernel launch for all
levels on the card, and on the CPU its plain version; otherwise it is that
plain version (`corr_lookup_plain`, a chain of PyTorch ops) under autograd,
as it is for CPU inputs the kernel does not take (float64 coords, float16
levels; `kernels.dispatch` chooses; on the card the wrapper raises on them). Both give the same bits. The 1D lookup
is the operator `kernels/corr.corr_lookup_1d` under the same rule.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..kernels import corr as corr_kernel

__all__ = ["CorrPyramid", "build_corr_pyramid", "corr_lookup", "build_corr_pyramid_1d",
           "corr_lookup_1d"]


class CorrPyramid(NamedTuple):
    """levels[i] has shape (B, H*W, H/2^i, W/2^i); a 1D pyramid's (B*H*W, 1,
    W/2^i)."""

    levels: Tuple[torch.Tensor, ...]


def _avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H//2, W//2) mean; an odd last row/column is
    dropped (30 -> 15 -> 7)."""
    s = x.shape
    h2, w2 = s[-2] // 2, s[-1] // 2
    x = x[..., : h2 * 2, : w2 * 2].reshape(*s[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def _sqrt_c(fmap: torch.Tensor) -> torch.Tensor:
    """sqrt(C) of features (..., C), rounded in their dtype, as an f32
    tensor on their device."""
    # Filled on the device (a copy from the host would synchronise, which a
    # CUDA graph capture refuses), and divided by as a tensor: a host scalar
    # divisor becomes a multiply by its reciprocal on the card.
    return torch.full((), float(torch.tensor(fmap.shape[-1], dtype=fmap.dtype).sqrt()),
                      dtype=torch.float32, device=fmap.device)


def build_corr_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4
) -> CorrPyramid:
    """fmap1, fmap2 (B, H, W, C) -> pyramid of (B, H*W, H/2^i, W/2^i) f32
    correlations scaled by 1/sqrt(C)."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).to(torch.float32)
    f2 = fmap2.reshape(B, H * W, C).to(torch.float32)
    corr = (f1 @ f2.transpose(1, 2)) / _sqrt_c(fmap1)
    levels = [corr.reshape(B, H * W, H, W)]
    for _ in range(num_levels - 1):
        levels.append(_avg_pool2x2(levels[-1]))
    return CorrPyramid(levels=tuple(levels))


def corr_lookup(
    pyramid: CorrPyramid, coords: torch.Tensor, radius: int = 4
) -> torch.Tensor:
    """Sample a (2r+1)^2 window around coords/2^i at every level.

    coords (B, H, W, 2) at the 1/8 grid -> (B, H, W, L*(2r+1)^2),
    level-major, and within a level x-offset-major (dx-major, dy fastest),
    the reference's concat order that converted `convc1` weights need.
    """
    return kernels.dispatch("corr_lookup", corr_kernel.corr_lookup, list(pyramid.levels),
                            coords, radius)


def build_corr_pyramid_1d(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4
) -> CorrPyramid:
    """RAFT-Stereo's `CorrBlock1D` volume: fmap1, fmap2 (B, H, W, C) ->
    levels (B*H*W, 1, W/2^i) f32, for each position of fmap1 the
    correlations with every column of fmap2's same row, scaled by
    1/sqrt(C), each level the last pooled by two along the row (an odd last
    column dropped). One batched f32 matmul over the B*H rows (exact f32 on
    the card where TF32 is off)."""
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B * H, W, C).to(torch.float32)
    f2 = fmap2.reshape(B * H, W, C).to(torch.float32)
    corr = torch.bmm(f1, f2.transpose(1, 2)).div_(_sqrt_c(fmap1))
    levels = [corr.reshape(B * H * W, 1, W)]
    for _ in range(num_levels - 1):
        x = levels[-1]
        w2 = x.shape[-1] // 2
        levels.append(x[..., : 2 * w2].reshape(x.shape[0], 1, w2, 2).mean(dim=-1))
    return CorrPyramid(levels=tuple(levels))


def corr_lookup_1d(pyramid: CorrPyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Sample 2r+1 taps along the row around x/2^i at every level of a 1D
    pyramid: coords (B, H, W, 2) (x read) -> (B, H, W, L*(2r+1)) f32,
    level-major, RAFT-Stereo's concat order."""
    return kernels.dispatch("corr_lookup_1d", corr_kernel.corr_lookup_1d,
                            list(pyramid.levels), coords, radius)
