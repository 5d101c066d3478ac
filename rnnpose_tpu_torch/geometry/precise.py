"""Exact-f32 matmul and einsum for pose-critical math, and the JAX
package's f32 rounding forms (port of `rnnpose_tpu/geometry/precise.py`).

On the card a f32 matmul may run in TF32 (10-bit mantissa), about 5e-4
relative: millimetres on a pose or a transformed point, fatal for ADD
thresholds down to 2 mm. These wrappers turn TF32 off for matmuls when an
operand lies on the card, then compute; use them for poses, points and
metrics.

`fma` and `recip` write a formula in the form that XLA's CPU backend gives
the JAX package's code, so that both packages round alike, on the CPU and
on the card:
* a multiply that feeds an add or a subtract is contracted into one fused
  multiply-add (`a * b + c`, rounded once);
* a division by a constant known at trace time becomes a multiply by the
  constant's f32 reciprocal (`x / c` -> `x * f32(1 / c)`).
A number divided by a tensor is written as a tensor divided by a tensor
(`torch.full_like(x, c) / x`): torch computes `c / x` as `x.reciprocal() *
c`, two roundings where jnp divides once.
Both are defined in `kernels/geometry` (which imports nothing of the
package) and used from there.
"""
from __future__ import annotations

import torch

from ..kernels.geometry import fma, recip

__all__ = ["pmatmul", "peinsum", "fma", "recip"]


def _tf32_off(*tensors: torch.Tensor) -> None:
    if any(t.is_cuda for t in tensors):
        torch.backends.cuda.matmul.allow_tf32 = False


def pmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _tf32_off(a, b)
    return torch.matmul(a, b)


def peinsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    _tf32_off(*operands)
    return torch.einsum(equation, *operands)
