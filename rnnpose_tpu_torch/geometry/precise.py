"""Exact-f32 matmul and einsum for pose-critical math (port of
`rnnpose_tpu/geometry/precise.py`).

On the card a f32 matmul may run in TF32 (10-bit mantissa), about 5e-4
relative: millimetres on a pose or a transformed point, fatal for ADD
thresholds down to 2 mm. These wrappers turn TF32 off for matmuls when an
operand lies on the card, then compute; use them for poses, points and
metrics.
"""
from __future__ import annotations

import torch

__all__ = ["pmatmul", "peinsum"]


def _tf32_off(*tensors: torch.Tensor) -> None:
    if any(t.is_cuda for t in tensors):
        torch.backends.cuda.matmul.allow_tf32 = False


def pmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _tf32_off(a, b)
    return torch.matmul(a, b)


def peinsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    _tf32_off(*operands)
    return torch.einsum(equation, *operands)
