"""The port's hand-written CUDA kernels, the lowest layer of the port: the
raster z-buffer sweeps (`raster`), the LM step (`lm`), the correlation
lookups, 2D and 1D (`corr`), and the instance norm (`norm`), each with its plain
version, the plain geometry the LM step is made of (`geometry`), and their
build (`build`). The `.cu` sources are in `csrc/`.

Each operator is a `torch.library` operator of the `rnnpose` namespace
(`torch.ops.rnnpose.<name>`), so that `torch.export` and other tracers see
it as one node. `OPS` is their one table: each record holds the schema, the
CPU implementation (the plain version), the CUDA implementation (the
kernel's launch on the current stream), the fake implementation (the
outputs' shapes and types) and the `csrc/` source whose library the CUDA
implementation loads. The wrappers of the submodules check their arguments
(on shapes, so the checks also run while tracing) and call the operator on
either device. The operators have no gradient. `dispatch` (and
`uses_kernel`, its test) is the one place that sends a call of the no-grad
operators (`lm_step`, both lookups, `instance_norm`) to the kernel or to the
plain version: the plain chain under autograd, and for every CPU input whose
dtype the kernel does not take (the record's `takes`: float64 and float16
go to the chain, which computes in their own dtype; the operator's CPU
implementation is that chain anyway), the kernel otherwise. A card input of
such a dtype goes to the kernel's wrapper, which raises: on the card a
kernel never gives way to the chain in silence.

The first copy of this package imported in a process registers the
operators (`REGISTERED`), and its `LAUNCHES` counts each operator's kernel
launches. The package imports only torch and the standard library, so a
serving bundle carries a byte-for-byte copy and a process without the port
loads it by path (`utils/bundle.py`).
"""
from __future__ import annotations

import collections
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from . import build, corr, lm, norm, raster  # noqa: F401  (the bundle reads `build`)


class Operator(NamedTuple):
    schema: str
    cpu: Callable
    cuda: Callable
    fake: Callable
    source: Path
    # Whether the kernel takes the arguments' dtypes (the no-grad operators
    # that `dispatch` serves; None for the raster sweeps, which it does not).
    takes: Optional[Callable] = None


OPS_NAMESPACE = "rnnpose"
_ATTRS_SCHEMA = ("(Tensor face_data, Tensor bbox, Tensor corner_attrs, int h, int w, int chunk, "
                 "int tile) -> (Tensor, Tensor, Tensor)")
OPS = {
    "zbuffer_sweep_rows_attrs": Operator(
        _ATTRS_SCHEMA, raster.zbuffer_sweep_rows_attrs_plain, raster.rows_attrs_cuda,
        raster.fake_attrs, raster.ROWS_ATTRS_SOURCE),
    "zbuffer_sweep_tiled_attrs_batched": Operator(
        _ATTRS_SCHEMA, raster.zbuffer_sweep_rows_attrs_plain, raster.tiled_attrs_batched_cuda,
        raster.fake_attrs, raster.TILED_ATTRS_SOURCE),
    "zbuffer_sweep_tiled_attrs": Operator(
        _ATTRS_SCHEMA, raster.zbuffer_sweep_tiled_attrs_plain, raster.tiled_attrs_cuda,
        raster.fake_attrs, raster.TILED_ATTRS_SOURCE),
    "zbuffer_sweep_tiled": Operator(
        "(Tensor face_data, Tensor bbox, int h, int w, int chunk, int tile) -> (Tensor, Tensor)",
        raster.zbuffer_sweep_tiled_plain, raster.tiled_cuda,
        lambda face_data, bbox, h, w, chunk, tile: raster.fake_z_fid(face_data, h, w),
        raster.TILED_SOURCE),
    "zbuffer_sweep": Operator(
        "(Tensor face_data, int h, int w, int chunk) -> (Tensor, Tensor)",
        raster.brute_cpu, raster.brute_cuda,
        lambda face_data, h, w, chunk: raster.fake_z_fid(face_data, h, w), raster.TILED_SOURCE),
    "lm_step": Operator(
        "(Tensor T, Tensor target, Tensor weight, Tensor depth, Tensor intrinsics, "
        "float lm_lambda, float ep_lambda, float delta_clamp, float min_depth) -> Tensor",
        lm.lm_step_plain, lm.lm_step_cuda, lambda T, *args: T.new_empty((T.shape[0], 4, 4)),
        lm.SOURCE, lm.takes),
    "corr_lookup": Operator(
        "(Tensor[] levels, Tensor coords, int radius) -> Tensor",
        corr.corr_lookup_plain, corr.corr_lookup_cuda,
        lambda levels, coords, radius: coords.new_empty(
            tuple(coords.shape[:3]) + (len(levels) * (2 * radius + 1) ** 2,)),
        corr.SOURCE, corr.takes),
    "instance_norm": Operator(
        "(Tensor x, float eps, bool relu) -> Tensor",
        norm.instance_norm_plain, norm.instance_norm_cuda,
        lambda x, eps, relu: torch.empty_like(x), norm.SOURCE, norm.takes),
    "corr_lookup_1d": Operator(
        "(Tensor[] levels, Tensor coords, int radius) -> Tensor",
        corr.corr_lookup_1d_plain, corr.corr_lookup_1d_cuda,
        lambda levels, coords, radius: coords.new_empty(
            tuple(coords.shape[:3]) + (len(levels) * (2 * radius + 1),)),
        corr.SOURCE, corr.takes),
}
OPERATORS = tuple(OPS)
SOURCES = tuple(dict.fromkeys(op.source for op in OPS.values()))
# Operator -> its kernel launches in this process (CUDA implementation calls).
LAUNCHES = collections.Counter()


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def uses_kernel(name: str, *args) -> bool:
    """Whether a call of no-grad operator `name` on `args` goes to its
    kernel: no gradient is kept through them (grad mode is off, or none of
    their tensors requires one), and the kernel takes their dtypes (the
    record's `takes`) or one of them is off the CPU (where the wrapper
    raises on a dtype it does not take). Otherwise the caller runs the
    plain chain."""
    tensors = list(_tensors(args))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return OPS[name].takes(*args) or any(t.device.type != "cpu" for t in tensors)


def dispatch(name: str, kernel: Callable, *args):
    """`kernel(*args)` (the submodule's wrapper, which checks the arguments
    and calls the operator) where `uses_kernel(name, *args)`, else the
    operator's plain version (`OPS[name].cpu`) on the same arguments."""
    return (kernel if uses_kernel(name, *args) else OPS[name].cpu)(*args)


def _counted(name: str, launch: Callable) -> Callable:
    def counted(*args, **kwargs):
        out = launch(*args, **kwargs)
        LAUNCHES[name] += 1
        return out

    return counted


# The operators' library, made by the copy of this package that registers. A
# `torch.library.Library` and not `torch.library.custom_op`, whose kernels
# import `torch._dynamo` on a process's first call (7.4 s on an H100 host
# with Triton installed, which it imports too).
LIBRARY = None
REGISTERED = not all(hasattr(getattr(torch.ops, OPS_NAMESPACE), name) for name in OPS)
if REGISTERED:
    LIBRARY = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
    for _name, _op in OPS.items():
        LIBRARY.define(_name + _op.schema)
        LIBRARY.impl(_name, _op.cpu, "CPU")
        LIBRARY.impl(_name, _counted(_name, _op.cuda), "CUDA")
        torch.library.register_fake(f"{OPS_NAMESPACE}::{_name}", _op.fake, lib=LIBRARY)
