"""Run a serving bundle in a process that has none of this package: the
consumer side of `tools/export_model.py`.

Usage:
  python rnnpose_tpu_torch/tools/serve_bundle.py BUNDLE EXAMPLE [--device cuda|cpu]

It blocks `rnnpose_tpu`, `rnnpose_tpu_torch`, `jax` and `flax` in
`sys.modules` (any import of them raises), loads the bundle's own copy of
`utils/bundle.py` by path, and through it the bundle's copy of the
`kernels/` package (which registers the `rnnpose` operators and, for
`cuda`, takes the bundle's prebuilt kernel libraries) and the program. On
`cuda` it turns TF32 off, as the manifest of an artifact of this package
requires, and runs under `torch.use_deterministic_algorithms(True)`, the
mode the expected output was computed in. It runs the program on the
example of `export_model --save_example` (`T_init`, the leaves, the
expected `Ti_pred`) and prints one JSON line: the max |Ti_pred - expected|,
the kernel launches its own operators counted, the load and run times
(host clock, synchronised) and any blocked module that was imported; it
exits 1 if the difference exceeds TOL or a blocked module was imported. It
needs torch alone (and the CUDA toolkit's runtime for `cuda`).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BLOCKED = ("rnnpose_tpu", "rnnpose_tpu_torch", "jax", "flax")
# The same program on the same inputs in the same mode reproduces the
# expected output; the bound is a few f32 ulps of a pose entry near 1.
TOL = 1e-6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run a serving bundle without the package")
    p.add_argument("bundle")
    p.add_argument("example")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    for name in BLOCKED:
        sys.modules[name] = None  # any import of these now raises ImportError
    # cuBLAS is deterministic only with a fixed workspace, set before its
    # first handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    bundle = Path(args.bundle)
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location("rnnpose_bundle_format", bundle / "bundle.py")
    fmt = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = fmt
    spec.loader.exec_module(fmt)
    ops = fmt.load_ops(bundle)
    program, manifest = fmt.load(bundle, ops)
    run = program.module()
    load_s = time.perf_counter() - t0
    data = torch.load(args.example, map_location=args.device, weights_only=True)
    torch.use_deterministic_algorithms(args.device == "cuda")
    t0 = time.perf_counter()
    got = run(data["T_init"], *data["leaves"])
    if args.device == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    err = float((got - data["expected"]).abs().max())
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
    print(json.dumps({
        "max_abs_diff": err, "tol": TOL, "shape": list(got.shape),
        "finite": bool(torch.isfinite(got).all()), "device": args.device,
        "launches": {name: ops.LAUNCHES[name] for name in ops.OPERATORS},
        "load_s": load_s, "run_s": run_s, "leaked": leaked,
        "manifest_device": manifest["device"]}), flush=True)
    return 0 if err <= TOL and not leaked else 1


if __name__ == "__main__":
    sys.exit(main())
