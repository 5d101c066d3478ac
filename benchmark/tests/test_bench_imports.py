"""No module under benchmark/ imports jax or the JAX package, and the
reference imports nothing of the program: each imported module's
top-level name (before the first dot) is compared whole, since the
program's name, rnnpose_tpu_torch, begins with the JAX package's."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark.tests._bench_common import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "optax", "orbax", "rnnpose_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "rnnpose_tpu_torch" not in set(_imports(path)), path
    code = ("import sys, benchmark.reference.models.rnnpose, benchmark.reference.train.step, "
            "benchmark.reference.data.pyramid, benchmark.reference.data.poses, "
            "benchmark.reference.render.mesh, benchmark.gen, benchmark.check, benchmark.trace;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & (JAX | {"rnnpose_tpu_torch"}), tops


def test_the_harness_check_compares_whole_names():
    from benchmark.run import forbidden_modules

    sys.modules.setdefault("rnnpose_tpu_torch_like", sys)
    try:
        assert "rnnpose_tpu" not in forbidden_modules()
    finally:
        del sys.modules["rnnpose_tpu_torch_like"]
