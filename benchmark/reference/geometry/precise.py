"""Exact-f32 matmul and einsum for pose-critical math, and the JAX
package's f32 rounding forms (port of `rnnpose_tpu/geometry/precise.py`).

On the card a f32 matmul may run in TF32 (10-bit mantissa), about 5e-4
relative. In this frozen copy the wrappers only compute: the benchmark's
harness sets the TF32 flags for the whole reference.

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
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["pmatmul", "peinsum", "fma", "recip"]

Operand = Union[torch.Tensor, float]


def pmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def peinsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    return torch.einsum(equation, *operands)


def recip(c: float) -> float:
    """f32(1 / c): the constant XLA multiplies by where the JAX code divides
    by `c` (computed in f32, as XLA folds it)."""
    return float(np.float32(1.0) / np.float32(c))


def _f32(x: float) -> float:
    return float(np.float32(x))  # a traced Python number is an f32 constant


def fma(a: Operand, b: Operand, c: Operand) -> torch.Tensor:
    """`a * b + c` with the product unrounded, as XLA's CPU backend contracts
    it: the f32 product is exact in f64, the sum is rounded to f64 and then
    to the tensors' dtype. That double rounding differs from a true fused
    multiply-add only at rare ties; f64 arithmetic gives the same bits on
    the CPU and on the card. One f64 kernel (the f32 operands are widened
    inside it) and the cast back; differentiable; Python numbers are f32
    constants."""
    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    like = tensors[0]
    # c64 carries the most dimensions, so type promotion computes in f64 (a
    # tensor of fewer dimensions would promote like a scalar).
    nd = max(x.dim() for x in tensors)
    if isinstance(c, torch.Tensor):
        c64 = c.double().reshape((1,) * (nd - c.dim()) + tuple(c.shape))
    else:
        c64 = torch.full((1,) * nd, _f32(c), dtype=torch.float64, device=like.device)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        out = torch.addcmul(c64, a, b)
    elif isinstance(a, torch.Tensor):
        out = torch.add(c64, a, alpha=_f32(b))
    else:
        out = torch.add(c64, b, alpha=_f32(a))
    return out.to(like.dtype)
