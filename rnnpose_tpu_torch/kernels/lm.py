"""The LM step (`csrc/lm_step.cu`, plain version `lm_step_plain`): one damped
Gauss-Newton step of the refiner's pose solve, `geometry/lm._lm_step` after
`reprojection_optim`'s back-projection (`geometry/lm.reprojection_optim`
calls it where no gradient is needed). It ports no TPU kernel: the JAX
package leaves the step to XLA, and in PyTorch ops it is a chain of some 357
kernels. The note at the top of the source says what bounds it and what its
design does.
"""
from __future__ import annotations

import ctypes

import torch

from .build import CSRC, check_device, check_launch, entry
from .geometry import backproject, lm_normal_equations, se3_expm, solve_spd

SOURCE = CSRC / "lm_step.cu"
_P, _I, _F, _L, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
                      ctypes.c_double)
_ARGS = (_P,) * 6 + (_I,) * 5 + (_L,) * 8 + (_F,) + (_D,) * 3 + (_P,)
LM_TILE = 128        # pixels a block at least: the 1/8 grid's 30^2 is 8 blocks
LM_MAX_TILES = 16    # blocks an item at most: one cluster, the H100's largest
LM_MAX_ITEMS = 65535  # the kernel's grid holds an item a row


def lm_step(
    T: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    lm_lambda: float = 1e-4,
    ep_lambda: float = 100.0,
    delta_clamp: float = 1.0,
    min_depth: float = 0.1,
) -> torch.Tensor:
    """One LM step of T (B, 4, 4) against the target pixel field (B, H, W,
    2) with per-pixel weights (B, H, W, 2), on the points back-projected from
    `depth` (B, H, W) with `intrinsics` (B, 4); all float32; the new T
    (B, 4, 4). The constants are `geometry/lm.LMConfig`'s.

    Calls the operator `torch.ops.rnnpose.lm_step`: a CUDA tensor launches
    the kernel (weight and target are read through their strides, so a
    stride-0 channel is not copied) and raises if it cannot; a CPU tensor
    runs `lm_step_plain`. No gradient: `geometry/lm.reprojection_optim`
    calls it only where none is needed.
    """
    if T.dim() != 3 or tuple(T.shape[1:]) != (4, 4) or depth.dim() != 3:
        raise ValueError(f"T must be (B, 4, 4) and depth (B, H, W), got {tuple(T.shape)} "
                         f"and {tuple(depth.shape)}")
    B, h, w = depth.shape
    shapes = {"T": (B, 4, 4), "target": (B, h, w, 2), "weight": (B, h, w, 2),
              "intrinsics": (B, 4)}
    for name, t in (("T", T), ("target", target), ("weight", weight), ("depth", depth),
                    ("intrinsics", intrinsics)):
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != T.device:
            raise ValueError(f"{name} is on {t.device}, T on {T.device}")
    if h < 1 or w < 1 or not 1 <= B <= LM_MAX_ITEMS:
        raise ValueError(f"depth must be (B, H, W) with pixels and 1 <= B <= {LM_MAX_ITEMS}, "
                         f"got {tuple(depth.shape)}")
    check_device(T)
    return torch.ops.rnnpose.lm_step(T, target, weight, depth, intrinsics, lm_lambda,
                                     ep_lambda, delta_clamp, min_depth)


def takes(*args) -> bool:
    """Whether the kernel takes the arguments' dtypes: every tensor float32
    (`kernels.dispatch`)."""
    return all(t.dtype == torch.float32 for t in args if isinstance(t, torch.Tensor))


def lm_step_cuda(T, target, weight, depth, intrinsics, lm_lambda, ep_lambda, delta_clamp,
                 min_depth):
    """The operator's CUDA implementation, one launch of `csrc/lm_step.cu` on
    the current stream: the new T (B, 4, 4), allocated here.
    Each item's pixels are split over at most LM_MAX_TILES blocks of at least
    LM_TILE pixels, one cluster."""
    T, depth, intrinsics = T.contiguous(), depth.contiguous(), intrinsics.contiguous()
    B, h, w = depth.shape
    tiles = min(LM_MAX_TILES, -(-h * w // LM_TILE))
    dev = T.device
    out = torch.empty((B, 4, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = entry(SOURCE, "rnnpose_lm_step", _ARGS)(
            T.data_ptr(), target.data_ptr(), weight.data_ptr(), depth.data_ptr(),
            intrinsics.data_ptr(), out.data_ptr(), B, h, w, tiles, -(-h * w // tiles),
            *target.stride(), *weight.stride(), min_depth, lm_lambda, ep_lambda,
            delta_clamp, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "LM step")
    return out


def lm_step_plain(
    T: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    lm_lambda: float = 1e-4,
    ep_lambda: float = 100.0,
    delta_clamp: float = 1.0,
    min_depth: float = 0.1,
) -> torch.Tensor:
    """`lm_step`'s contract in plain PyTorch, on any device: the
    back-projection of `reprojection_optim`, then `geometry/lm._lm_step`
    (the normal equations, the solve and the increment of
    `kernels/geometry`, the functions it calls)."""
    X0 = backproject(depth, intrinsics)
    valid = (depth > min_depth).to(depth.dtype)
    H, b = lm_normal_equations(T, target, weight, X0, valid, intrinsics, min_depth, lm_lambda,
                               ep_lambda)
    return se3_expm(solve_spd(H, b, delta_clamp).to(T.dtype)) @ T
