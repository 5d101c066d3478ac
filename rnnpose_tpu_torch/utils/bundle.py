"""The serving bundle's format: its writer and its reader in one module.

It imports only torch and the standard library, and a bundle carries a
byte-for-byte copy of it beside a copy of the operator package (`kernels/`),
so a process without this package reads a bundle through the bundle's own
files. A bundle is a directory holding

* `model.pt2`, the `torch.export` program;
* `manifest.json`: the caller's keys (`utils/export.save_exported`: the
  signature, each leaf's path, shape and dtype, the raster choices) and this
  module's: `program`, `device`, `tf32` (whether the artifact may run its
  matmuls and convolutions in TF32 on `cuda`), `modules` (the sha256 of each
  module copy, by path in the bundle), `operators` (the namespace, the
  operator nodes, the kernel libraries), `bytes` (the program) and
  `bundle_bytes`;
* `kernels/*.py` and `bundle.py`, the module copies;
* on `cuda`, the kernel libraries that the program's operators load (the
  sources that the operator table names for them).

In this package `utils/export.save_exported` and `load_exported` call
`write` and `load` with the port's `kernels` package. A process without the
package loads the bundle's `bundle.py` by path, then `ops = load_ops(DIR)`
and `program, manifest = load(DIR, ops)` (`tools/serve_bundle.py`).
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import torch

__all__ = ["MANIFEST", "PROGRAM", "operator_nodes", "write", "load_ops", "load"]

MANIFEST = "manifest.json"
PROGRAM = "model.pt2"
KERNELS = "kernels"  # the operator package's directory in a bundle


def _sha256(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _copies(ops) -> dict:
    """The module copies a bundle holds, by kind: path in the bundle -> this
    process's file."""
    package = Path(ops.__file__).parent
    return {"operators": {f"{KERNELS}/{p.name}": p for p in sorted(package.glob("*.py"))},
            "format": {"bundle.py": Path(__file__)}}


def operator_nodes(exported, namespace: str):
    """Nodes of each `namespace` operator in the program, nested graphs (a
    `torch.no_grad()` region becomes one) included."""
    found = {}
    for module in exported.graph_module.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
            name = getattr(node.target, "name", None)
            if node.op == "call_function" and callable(name) and name().startswith(
                    f"{namespace}::"):
                key = name().split("::")[1].split(".")[0]
                found[key] = found.get(key, 0) + 1
    return found


def write(exported, directory, ops, device: str, tf32: bool, manifest: dict) -> dict:
    """Write `exported`, an artifact for `device` ("cuda" or "cpu") whose
    operators are those of `ops` (the operator package), as a bundle in
    `directory`, with the caller's `manifest` keys; return the full
    manifest. `tf32` is whether it may run in TF32 on `cuda`. The kernel
    libraries of a `cuda` artifact are built here if they are not built
    yet."""
    directory = Path(directory)
    (directory / KERNELS).mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, directory / PROGRAM)
    modules = {}
    for kind, files in _copies(ops).items():
        for name, source in files.items():
            shutil.copyfile(source, directory / name)
        modules[kind] = {name: _sha256(directory / name) for name in files}
    nodes = operator_nodes(exported, ops.OPS_NAMESPACE)
    libraries = {}
    if device == "cuda":
        for source in sorted({ops.OPS[op].source for op in nodes}):
            lib = ops.build.build_kernel(source)
            shutil.copyfile(lib, directory / lib.name)
            libraries[source.stem] = lib.name
    manifest = dict(manifest, program=PROGRAM, device=device, tf32=tf32, modules=modules,
                    operators={"namespace": ops.OPS_NAMESPACE, "nodes": nodes,
                               "libraries": libraries})
    manifest["bytes"] = (directory / PROGRAM).stat().st_size
    # The program, the module copies and the libraries.
    manifest["bundle_bytes"] = sum(p.stat().st_size for p in directory.rglob("*")
                                   if p.is_file() and p.name != MANIFEST)
    (directory / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


def _manifest(directory: Path) -> dict:
    return json.loads((directory / MANIFEST).read_text())


def load_ops(directory):
    """The bundle's copy of the operator package, loaded by path; importing
    it registers the operators in a process where no copy has yet."""
    package = Path(directory) / KERNELS
    name = "rnnpose_bundle_ops"
    for stale in [m for m in sys.modules if m == name or m.startswith(name + ".")]:
        del sys.modules[stale]  # another bundle's copy: its submodules are not this one's
    spec = importlib.util.spec_from_file_location(
        name, package / "__init__.py", submodule_search_locations=[str(package)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def load(directory, ops):
    """Load a bundle into this process: (the `ExportedProgram`, its
    manifest); run it as `program.module()(T_init, *leaves)`.

    `ops` is the operator package that registered the operators in this
    process (`ops.REGISTERED`): the port's, or the bundle's own copy
    (`load_ops`). Its files and this module must be byte-for-byte the
    bundle's copies. Each kernel library the bundle carries is used where
    `ops` has no sources beside it; where it has, they must be the sources
    the library was built from (same `library_name`). A `cuda` artifact made
    without TF32 is refused while TF32 is on for matmuls or cuDNN: turn
    `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` off first.
    """
    directory = Path(directory)
    manifest = _manifest(directory)
    if not ops.REGISTERED:
        raise RuntimeError(
            f"the {ops.OPS_NAMESPACE} operators were registered by another copy of "
            "the operator package: load the bundle through that copy")
    for kind, files in _copies(ops).items():
        recorded = manifest["modules"][kind]
        for name in sorted(set(files) | set(recorded)):
            copy = directory / name
            if not (name in files and copy.is_file()
                    and _sha256(files[name]) == _sha256(copy) == recorded.get(name)):
                raise RuntimeError(f"the bundle's {name} differs from {files.get(name)}")
    sources = {s.stem: s for s in ops.SOURCES}
    for stem, name in manifest["operators"]["libraries"].items():
        if sources[stem].exists():
            if ops.build.library_name(sources[stem]) != name:
                raise RuntimeError(f"the bundle's {name} was not built from {sources[stem]}")
        else:
            ops.build.PREBUILT[stem] = directory / name
    if manifest["device"] == "cuda" and not manifest["tf32"] and (
            torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32):
        raise RuntimeError(
            "this artifact runs its matmuls and convolutions without TF32: set "
            "torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32 "
            "to False before loading it")
    return torch.export.load(directory / manifest["program"]), manifest
