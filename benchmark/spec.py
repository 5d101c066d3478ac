"""The benchmark's data: `BENCHMARK.json` and the files its entries name.

Every cell names a configuration and a traffic mix; the harness finds the
configuration's file through `BENCHMARK.json`, the traffic mix as
`benchmark/traffic/<name>.json`, the runner of the mix's `kind` as
`benchmark/runners/<kind>.py` (`run.find_runner`) and each metric's reader
as `benchmark/metrics/<name>.py`. Adding a configuration, a traffic mix, a
kind of traffic (a new model's runner among them) or a metric adds files
and entries; no file of the harness changes. The limits of a kind that a
configuration file does not hold come from the traffic file
(`run.cell_limits`).
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Spec", "load_spec"]

HERE = os.path.dirname(os.path.abspath(__file__))


class Spec:
    """`BENCHMARK.json` at `root`, with lookups by name."""

    def __init__(self, root: str, doc: Dict[str, Any], bench_dir: str = HERE):
        self.root, self.doc, self.bench_dir = root, doc, bench_dir

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.doc["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        with open(os.path.join(self.bench_dir, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, cell: str, kind: str) -> List[Dict[str, Any]]:
        """The entries of `kind` ("end_to_end" or "per_layer") that `cell`
        reports: those with no `workloads` key and those that list it."""
        return [m for m in self.doc[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
        """The `read(ctx)` function of `metrics/<metric>.py`."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def load_spec(root: str, bench_dir: str = HERE) -> Spec:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return Spec(root, json.load(f), bench_dir)
