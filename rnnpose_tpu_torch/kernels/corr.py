"""The correlation lookups (`csrc/corr_lookup.cu`): the 2D one (plain
version `corr_lookup_plain`), the (2r+1)^2 window of every pyramid level
around each position, all levels at once, and RAFT-Stereo's 1D one along
image rows (`corr_lookup_1d`, plain version `corr_lookup_1d_plain`), the
2r+1 taps of every level; `ops/corr` calls them where no gradient is needed.
They port no TPU kernel: the JAX package leaves the lookup to XLA, and in
PyTorch ops the 2D one is a chain of 257 kernels. The note at the top of the
source says what bounds them and what their design does.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CSRC, check_device, check_launch, entry

SOURCE = CSRC / "corr_lookup.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = (_P,) * 3 + (_I,) * 2 + (_P,) + (_I,) * 3 + (_L,) * 4 + (_I,) + (_P,) * 2
_ARGS_1D = (_P,) * 2 + (_I,) * 2 + (_P,) + (_I,) * 3 + (_L,) * 3 + (_I,) + (_P,) * 2
CORR_MAX_LEVELS = 8  # the kernel's level table


def corr_lookup(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """The windowed lookup of a correlation pyramid: `levels` (1 to
    CORR_MAX_LEVELS tensors (B, H*W, H_i, W_i), all float32 or all bfloat16),
    coords (B, H, W, 2) float32 at level 0's scale -> (B, H, W,
    L*(2r+1)^2) float32, level-major, dx-major, dy fastest.

    Calls the operator `torch.ops.rnnpose.corr_lookup`: a CUDA tensor
    launches the kernel (coords are read through their strides, so an
    expanded grid is not copied) and raises if it cannot; a CPU tensor runs
    `corr_lookup_plain`, which gives the same bits. No gradient:
    `ops/corr.corr_lookup` calls it only where none is needed.
    """
    levels = list(levels)
    B, H, W = _check_coords(levels, coords, radius)
    for i, level in enumerate(levels):
        if level.dim() != 4 or tuple(level.shape[:2]) != (B, H * W):
            raise ValueError(f"level {i} must be ({B}, {H * W}, h, w), got {tuple(level.shape)}")
    check_device(coords)
    return torch.ops.rnnpose.corr_lookup(levels, coords, radius)


def takes(levels, coords, radius) -> bool:
    """Whether the kernels take these arguments' dtypes: float32 coords and
    levels all float32 or all bfloat16 (`kernels.dispatch`)."""
    kinds = {level.dtype for level in levels}
    return coords.dtype == torch.float32 and kinds in ({torch.float32}, {torch.bfloat16})


def _check_coords(levels, coords, radius):
    """(B, H, W) of coords (B, H, W, 2) float32, after the checks that both
    lookups make of their arguments."""
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (B, H, W, 2), got {tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    B, H, W, _ = coords.shape
    if not 1 <= len(levels) <= CORR_MAX_LEVELS or not isinstance(radius, int) or radius < 0:
        raise ValueError(f"1 to {CORR_MAX_LEVELS} levels and a radius >= 0, got "
                         f"{len(levels)} and {radius!r}")
    if B * H * W < 1:
        raise ValueError(f"coords must hold positions, got {tuple(coords.shape)}")
    for i, level in enumerate(levels):
        if level.dtype not in (torch.float32, torch.bfloat16) or level.dtype != levels[0].dtype:
            raise TypeError(f"the levels must share one dtype, float32 or bfloat16; level {i} "
                            f"is {level.dtype}, level 0 {levels[0].dtype}")
        if level.device != coords.device:
            raise ValueError(f"level {i} is on {level.device}, coords on {coords.device}")
    return B, H, W


def corr_lookup_cuda(levels, coords, radius):
    """The operator's CUDA implementation, one launch of `csrc/corr_lookup.cu`
    on the current stream: the lookup (B, H, W, L*(2r+1)^2), allocated
    here."""
    levels = [level.contiguous() for level in levels]
    B, H, W, _ = coords.shape
    L, win = len(levels), 2 * radius + 1
    dev = coords.device
    out = torch.empty((B, H, W, L * win * win), dtype=torch.float32, device=dev)
    data = (ctypes.c_void_p * L)(*[level.data_ptr() for level in levels])
    hs = (ctypes.c_int * L)(*[level.shape[2] for level in levels])
    ws = (ctypes.c_int * L)(*[level.shape[3] for level in levels])
    with torch.cuda.device(dev):
        err = entry(SOURCE, "rnnpose_corr_lookup", _ARGS)(
            data, hs, ws, L, int(levels[0].dtype == torch.bfloat16), coords.data_ptr(), B, H,
            W, *coords.stride(), radius, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "correlation lookup")
    return out


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


def corr_lookup_plain(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """`corr_lookup`'s contract in plain PyTorch, on any device and under
    autograd: the four bilinear taps of every window position gathered
    directly (zero outside the level), in the JAX package's separable order
    (rows first, then columns); a level pooled to zero size reads 0."""
    B, H, W, _ = coords.shape
    Q = B * H * W
    win = 2 * radius + 1
    cx = coords[..., 0].reshape(Q)
    cy = coords[..., 1].reshape(Q)
    outs = []
    for i, corr in enumerate(levels):
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


def corr_lookup_1d(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """RAFT-Stereo's lookup along image rows: `levels` (1 to CORR_MAX_LEVELS
    tensors (B*H*W, 1, w_i), one row of correlations a query, all float32
    or all bfloat16), coords (B, H, W, 2) float32 at level 0's scale, of
    which x is read -> (B, H, W, L*(2r+1)) float32, level-major: at level
    i the linear taps of x / 2^i + dx, dx in [-r, r], zero outside the row.

    Calls the operator `torch.ops.rnnpose.corr_lookup_1d`: a CUDA tensor
    launches the kernel (coords are read through their strides) and raises
    if it cannot; a CPU tensor runs `corr_lookup_1d_plain`, which gives the
    same bits. No gradient: `ops/corr.corr_lookup_1d` calls it only where
    none is needed.
    """
    levels = list(levels)
    B, H, W = _check_coords(levels, coords, radius)
    for i, level in enumerate(levels):
        if level.dim() != 3 or tuple(level.shape[:2]) != (B * H * W, 1):
            raise ValueError(f"level {i} must be ({B * H * W}, 1, w), got "
                             f"{tuple(level.shape)}")
    check_device(coords)
    return torch.ops.rnnpose.corr_lookup_1d(levels, coords, radius)


def corr_lookup_1d_cuda(levels, coords, radius):
    """The operator's CUDA implementation, one launch of `csrc/corr_lookup.cu`
    (`rnnpose_corr_lookup_1d`) on the current stream: the lookup (B, H, W,
    L*(2r+1)), allocated here."""
    levels = [level.contiguous() for level in levels]
    B, H, W, _ = coords.shape
    L = len(levels)
    dev = coords.device
    out = torch.empty((B, H, W, L * (2 * radius + 1)), dtype=torch.float32, device=dev)
    data = (ctypes.c_void_p * L)(*[level.data_ptr() for level in levels])
    ws = (ctypes.c_int * L)(*[level.shape[2] for level in levels])
    with torch.cuda.device(dev):
        err = entry(SOURCE, "rnnpose_corr_lookup_1d", _ARGS_1D)(
            data, ws, L, int(levels[0].dtype == torch.bfloat16), coords.data_ptr(), B, H, W,
            *coords.stride()[:3], radius, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "1D correlation lookup")
    return out


def corr_lookup_1d_plain(levels, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """`corr_lookup_1d`'s contract in plain PyTorch, on any device and under
    autograd: per level the two linear taps of every window position
    gathered from the query's row (zero outside it), w0 v0 + w1 v1; a level
    pooled to zero width reads 0."""
    B, H, W, _ = coords.shape
    Q = B * H * W
    cx = coords[..., 0].reshape(Q)
    outs = []
    for i, corr in enumerate(levels):
        w = corr.shape[-1]
        if w == 0:  # a level pooled away: all taps 0
            outs.append(torch.zeros((Q, 2 * radius + 1), dtype=corr.dtype, device=corr.device))
            continue
        (i0, w0), (i1, w1) = _taps(cx * (1.0 / (2.0 ** i)), radius, w)
        row = corr.reshape(Q, w)
        outs.append(w0 * torch.gather(row, 1, i0) + w1 * torch.gather(row, 1, i1))
    return torch.cat(outs, dim=-1).reshape(B, H, W, -1)
