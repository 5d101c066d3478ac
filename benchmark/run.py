"""Run one cell of the benchmark once.

  python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's entry in `BENCHMARK.json` names its
configuration file and its traffic mix (`benchmark/traffic/<name>.json`),
whose `kind` names the runner, found by that name as
`benchmark/runners/<kind>.py` (`find_runner`): `serve` (the program's
`InferenceEngine.refine`), `train` (`Trainer.run_step` on batches made in
memory), `train_data` (`Trainer.run_step` on batches the program's loader
reads from LINEMOD-format files). A new kind of traffic, or a new model's
runner, is a new file there: no file of the harness changes. A kind with
no runner file fails before set-up, naming the file looked for. The
limits of the numbers a cell's check compares are the configuration's
set for the kind, or else the set the traffic names under `limits_of`,
with the limits the traffic file gives for numbers only its kind
produces (`cell_limits`). Set-up (imports, data, weights, the key's
warm-ups and its one capture, the warm-up requests or steps) is timed
from the start of this module to the window's start. The window runs
`--seconds`; no capture may happen in it. With `--trace 1` a stretch of
requests or steps after the window runs under `torch.profiler`, and the
line carries the cell's per-layer metrics instead of its end-to-end ones.
Then the program's state is freed and the plain reference
(`benchmark/reference`) judges what the window produced (the runner's
`judge`). The last line of stdout is one JSON object: correct, attempted,
failed, metrics, device, [breakdown], limits; the numbers compared, each
beside its limit, are also the last lines of stderr.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with status 2 and prints no result. It exits with status 3, and no result,
if JAX, flax or the JAX package is loaded in this process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "rnnpose_tpu")
KIND = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")  # a kind names a module

__all__ = ["main", "run_cell", "find_runner", "cell_limits"]


def _set_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: `rnnpose_tpu_torch` is not `rnnpose_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def profile(fn) -> Dict[str, Any]:
    """fn() under torch.profiler (host and CUDA activity): the trace's
    summary (`trace.summarize`) and the traced window's seconds."""
    import torch

    from . import trace

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with torch.profiler.profile(activities=activities) as prof:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        summary = trace.summarize(trace.load(path))
    summary["window_s"] = window
    return summary


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def find_runner(spec, kind: str):
    """The runner of traffic kind `kind`: the module `runners/<kind>.py` in
    the spec's benchmark directory, or else in this harness's own. Raises
    FileNotFoundError naming the files looked for."""
    if not KIND.match(kind):
        raise ValueError(f"traffic kind {kind!r} is not a module's name")
    paths = [os.path.join(d, "runners", f"{kind}.py") for d in dict.fromkeys(
        (os.path.abspath(spec.bench_dir), HERE))]
    for path in paths:
        if os.path.isfile(path):
            found = importlib.util.spec_from_file_location(f"benchmark_runner_{kind}", path)
            mod = importlib.util.module_from_spec(found)
            found.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no runner for traffic kind {kind!r}: looked for "
                            + " and ".join(paths))


def cell_limits(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> Dict[str, float]:
    """The limits of the numbers a cell's check compares: the
    configuration's set for the traffic's kind, or else the set the traffic
    names under `limits_of`, with the traffic's own `limits` added for
    numbers only its kind produces. A traffic file adds limits; one that
    names a number the configuration's set already holds is refused."""
    sets = cfg.get("limits", {})
    kind = traffic["kind"]
    base_name = kind if kind in sets else traffic.get("limits_of")
    if base_name is not None and base_name not in sets:
        raise KeyError(f"the configuration has no limits for {base_name!r}")
    base = dict(sets[base_name]) if base_name is not None else {}
    own = traffic.get("limits", {})
    clash = sorted(set(own) & set(base))
    if clash:
        raise ValueError(f"the traffic file sets limits the configuration holds: {clash}")
    return dict(base, **own)


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, hooks: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of a cell on `device`, past the chip check: the result
    object (without printing). `hooks` lets the tests plant faults."""
    import torch

    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    runner = find_runner(spec, traffic["kind"])
    limits = cell_limits(cfg, traffic)
    ctx = dict(config=cfg, traffic=traffic, device=device, seed=seed, seconds=seconds,
               trace=trace, t_start=t_start, profile=profile, **(hooks or {}))
    got = runner.run(ctx)
    rd = got["readings"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    # The plain reference judges the window's output (`cell_limits` holds
    # the limits of the numbers compared).
    numbers, flops = runner.judge(ctx, got, trace)
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    compared["failed"] = {"value": rd["failed"], "limit": 0}
    compared["new_captures"] = {"value": rd["new_captures"], "limit": 0}
    correct = all(v["value"] <= v["limit"] for v in compared.values())

    # Metrics by name, each read by `metrics/<name>.py`: the end-to-end
    # ones, or with a trace the per-layer ones.
    mctx = dict(rd, config=cfg, traffic=traffic, flops=flops)
    entries = spec.metrics(workload, "per_layer" if trace else "end_to_end")
    values = {m["name"]: spec.reader(m["name"])(mctx) for m in entries}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in entries if values[m["name"]] is not None}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": rd["memory_peak_bytes"],
                "power_limit": _power_limit() if device.type == "cuda" else None}
    result = {"correct": correct, "attempted": rd["requests"], "failed": rd["failed"],
              "metrics": metrics, "device": dev_info}
    if trace:
        tr = rd["traced"]
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr["families"]],
                               "idle_gaps": [[n, s] for n, s in tr["idle_gaps"]]}
    # Every scalar the check read, compared or not (`control.py` keeps them;
    # `main` leaves them out of the line).
    result["numbers"] = {k: v for k, v in numbers.items() if isinstance(v, (int, float))}
    result["limits"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_caches()

    from .spec import load_spec

    spec = load_spec(ROOT)
    chips = spec.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 3
    result.pop("numbers")
    for name, v in result["limits"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
