"""Serving export of the eval forward (`torch.export`): the port of
`rnnpose_tpu/utils/export.py`.

The artifact is the cached eval forward at its serving operating point: the
per-class 3D features come in precomputed (`RNNPose.encode_3d`, once per
class). Its callable is `(T_init, *leaves) -> Ti_pred`, the JAX artifact's
signature, where `leaves` holds, in order,

* the model's parameters and buffers in `state_dict` order, bound with
  `torch.func.functional_call`: they are inputs, not constants baked into
  the program, so one artifact per shape serves any checkpoint;
* the input tensors of `RNNPoseInputs` in field order (the mesh's fields in
  theirs), without `T_init`, the point pyramid (the cached forward does not
  read it) and the training correspondences, and without fields that are
  None;
* `desc3d` and `ctx3d`.

`T_init` rides apart, so a tracking server feeds each frame the previous
refined pose. The example tensors given to `torch.export` are fresh copies:
a tensor object passed both as `T_init` and among the leaves would be traced
as one input, and the artifact would then ignore the `T_init` it is given.

An artifact is exported for one device, as the JAX one is for one platform:
the operators (`kernels/`, `torch.ops.rnnpose.*`) are
nodes of the graph on both devices, and run the CUDA kernels or the plain
versions where the program is loaded. `save_exported` writes a bundle
directory (`utils/bundle.py`, the format): the program (`model.pt2`), a JSON
manifest (signature, device, torch version, each leaf's path, shape and
dtype, the raster choices frozen at trace time, the TF32 switch, the
bytes), byte-for-byte copies of the `kernels/` package and
`utils/bundle.py` and, for `cuda`, the kernel libraries its operators load.
A process without this package loads the bundle through those copies
(`tools/serve_bundle.py`); here `load_exported` does it. The CLI is
`python -m rnnpose_tpu_torch.tools.export_model`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.refiner import MeshAssets
from ..models.rnnpose import RNNPose, RNNPoseInputs
from .. import kernels
from ..render import raster as raster_mod
from . import bundle

__all__ = [
    "SIGNATURE",
    "serving_args",
    "serving_leaf_paths",
    "export_eval_forward",
    "operator_nodes",
    "call_exported",
    "save_exported",
    "load_exported",
    "save_example",
]

SIGNATURE = "(T_init, *leaves) -> Ti_pred"
_SKIPPED_INPUTS = ("T_init", "pyramid", "corr")


def _input_leaves(inputs: RNNPoseInputs) -> List[Tuple[str, torch.Tensor]]:
    out = []
    for field in inputs._fields:
        value = getattr(inputs, field)
        if field in _SKIPPED_INPUTS or value is None:
            continue
        if isinstance(value, MeshAssets):
            out += [(f"inputs.mesh.{f}", getattr(value, f)) for f in value._fields
                    if getattr(value, f) is not None]
        else:
            out.append((f"inputs.{field}", value))
    return out


def _tree(model: RNNPose, inputs: RNNPoseInputs, desc3d, ctx3d):
    leaves = [(f"params.{k}", v) for k, v in model.state_dict(keep_vars=True).items()]
    return leaves + _input_leaves(inputs) + [("desc3d", desc3d), ("ctx3d", ctx3d)]


def serving_args(model: RNNPose, inputs: RNNPoseInputs, desc3d, ctx3d) -> List[torch.Tensor]:
    """The artifact's leaves, in its positional order (see the module
    docstring), detached."""
    return [t.detach() for _, t in _tree(model, inputs, desc3d, ctx3d)]


def serving_leaf_paths(model: RNNPose, inputs: RNNPoseInputs, desc3d, ctx3d) -> List[str]:
    """The tree path of each leaf, e.g. `params.motion_net...weight`,
    `inputs.mesh.faces`, `desc3d` (the manifest's `leaves`)."""
    return [p for p, _ in _tree(model, inputs, desc3d, ctx3d)]


def _rebuild(paths: Sequence[str], values, T_init) -> RNNPoseInputs:
    fields, mesh = {"T_init": T_init}, {}
    for path, value in zip(paths, values):
        parts = path.split(".")[1:]
        if parts[0] == "mesh":
            mesh[parts[1]] = value
        else:
            fields[parts[0]] = value
    fields["mesh"] = MeshAssets(**mesh)
    return RNNPoseInputs(**{f: fields.get(f) for f in RNNPoseInputs._fields})


class _Serving(nn.Module):
    """`(T_init, *leaves) -> Ti_pred` over a model that is not a submodule,
    so that none of its tensors is lifted into the program."""

    def __init__(self, model: RNNPose, paths: Sequence[str]):
        super().__init__()
        self.__dict__["model"] = model
        self.n_state = sum(p.startswith("params.") for p in paths)
        self.state_names = [p[len("params."):] for p in paths[:self.n_state]]
        self.input_paths = list(paths[self.n_state:-2])

    def forward(self, T_init, *leaves):
        state = dict(zip(self.state_names, leaves[:self.n_state]))
        inputs = _rebuild(self.input_paths, leaves[self.n_state:-2], T_init)
        out = torch.func.functional_call(
            self.model, state, (inputs,),
            {"train": False, "cached_desc3d": leaves[-2], "cached_ctx3d": leaves[-1]})
        return out["Ti_pred"]


def export_eval_forward(model: RNNPose, inputs: RNNPoseInputs, desc3d: torch.Tensor,
                        ctx3d: torch.Tensor) -> torch.export.ExportedProgram:
    """Trace the cached eval forward with `torch.export` (non-strict) and
    return the program; `(T_init, *leaves)` with `leaves` from
    `serving_args`. Only the shapes, types and device of the arguments are
    used: the artifact is for the device they lie on, and it keeps no copy
    of them (`torch.export` would save the example, weights included, with
    the program). The model is put in eval mode."""
    model.eval()
    paths = serving_leaf_paths(model, inputs, desc3d, ctx3d)
    example = [inputs.T_init] + serving_args(model, inputs, desc3d, ctx3d)
    example = tuple(t.detach().clone() for t in example)
    exported = torch.export.export(_Serving(model, paths), example, strict=False)
    exported.example_inputs = None
    return exported


def _user_inputs(exported: torch.export.ExportedProgram) -> List[torch.Tensor]:
    """The fake tensors of the program's positional inputs, T_init first."""
    names = set(exported.graph_signature.user_inputs)
    return [n.meta["val"] for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in names]


def operator_nodes(exported: torch.export.ExportedProgram) -> Dict[str, int]:
    """Nodes of each `rnnpose` operator in the program."""
    return bundle.operator_nodes(exported, kernels.OPS_NAMESPACE)


def call_exported(exported, model: RNNPose, inputs: RNNPoseInputs, desc3d, ctx3d, T_init):
    """Call an artifact (an `ExportedProgram` or its `.module()`) with
    structured arguments."""
    run = exported.module() if isinstance(exported, torch.export.ExportedProgram) else exported
    return run(T_init, *serving_args(model, inputs, desc3d, ctx3d))


def save_exported(exported: torch.export.ExportedProgram, directory: str,
                  leaf_paths: Sequence[str], extra_manifest: Optional[dict] = None) -> dict:
    """Write the bundle directory (`utils/bundle.write`) and return its
    manifest. The kernel libraries of a `cuda` artifact are built here if
    they are not built yet."""
    args = _user_inputs(exported)
    nodes = operator_nodes(exported)
    manifest = {
        "signature": SIGNATURE,
        "torch": torch.__version__,
        "leaves": [{"path": p, "shape": list(t.shape), "dtype": str(t.dtype).split(".")[-1]}
                   for p, t in zip(leaf_paths, args[1:])],
        "T_init": {"shape": list(args[0].shape), "dtype": str(args[0].dtype).split(".")[-1]},
        "raster": {"grid": raster_mod._GRID_PREF, "tile": raster_mod._TILE_PREF,
                   "branch": "fused" if any("attrs" in op for op in nodes) else "unfused"},
    }
    manifest.update(extra_manifest or {})
    # The forward runs its matmuls and convolutions without TF32 on the card
    # (`models/rnnpose._exact_f32`); the artifact does not carry that switch.
    return bundle.write(exported, directory, kernels, args[0].device.type, False, manifest)


def load_exported(directory: str) -> Tuple[torch.export.ExportedProgram, dict]:
    """Load a bundle in this process through the package's operators:
    (ExportedProgram, manifest); see `utils/bundle.load`. Run it as
    `exported.module()(T_init, *leaves)`."""
    return bundle.load(directory, kernels)


def save_example(path: str, run, T_init: torch.Tensor,
                 leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Run the artifact `run` (a loaded program's `.module()`) on `T_init`
    and `leaves`, and write them with its output, the expected `Ti_pred`, on
    the host, in a file that `torch.load` alone reads (`weights_only=True`):
    a consumer's example. On `cuda` the output is computed under
    `torch.use_deterministic_algorithms(True)`, the mode in which a consumer
    reproduces it exactly. Returns the output."""
    mode = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(mode or T_init.is_cuda)
    try:
        expected = run(T_init, *leaves)
    finally:
        torch.use_deterministic_algorithms(mode)
    torch.save({"T_init": T_init.detach().cpu(),
                "leaves": [t.detach().cpu() for t in leaves],
                "expected": expected.detach().cpu()}, path)
    return expected
