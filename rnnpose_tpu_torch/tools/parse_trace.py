"""Sum device time per kernel, per family and per host op from a Chrome
trace (port of `rnnpose_tpu/tools/parse_trace.py`).

Reads the `trace.json` that `utils/profiling.trace` writes (and with it
`tools/profile_components --trace DIR`, under `DIR/eval` and `DIR/train`):
`torch.profiler`'s Chrome trace, not the TPU's xplane. Rules:

  * device events are the trace's `kernel`, `gpu_memcpy` and `gpu_memset`
    events; a name that is also a user annotation's (`annotate`,
    `record_function`) is left out, `utils/profiling.device_busy`'s rule:
    an annotation's span on the device covers the gaps between its kernels;
  * a device event's time is its own duration (`dur`): device events on
    one stream do not nest, so this is its self-time;
  * each device event is charged to the host op that launched it (the
    `cpu_op` with the same `External id`), "(no host op)" where none;
  * launches are the host's kernel-launch API calls (`cuda_runtime` or
    `cuda_driver` events named `cudaLaunchKernel*` or `cuLaunchKernel*`,
    the count `chip_smoke.py` prints for a training step).

Prints the device total, the launches, the top N families (`family`: a
kernel's base name, then the JAX tool's rule) or, with `--ops`, kernels,
and the top host ops; the last line is one JSON summary.

Usage:
  python -m rnnpose_tpu_torch.tools.parse_trace DIR_OR_trace.json [--top 25] [--ops]
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_CATS = ("user_annotation", "gpu_user_annotation")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")


def find_trace(path: str) -> str:
    """`path` itself, or the newest `trace.json` / `*.pt.trace.json` under it."""
    if os.path.isfile(path):
        return path
    found = (glob.glob(os.path.join(path, "**", "trace.json"), recursive=True)
             + glob.glob(os.path.join(path, "**", "*.pt.trace.json"), recursive=True))
    if not found:
        raise FileNotFoundError(f"no trace.json under {path}")
    return max(found, key=os.path.getmtime)


def family(name: str) -> str:
    """Coarse grouping key: a CUDA kernel's base name (no `void`, template
    arguments, parameters or namespaces), then the JAX tool's rule (the
    head before ` = `, then before the first `.`)."""
    head = re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0].strip()
    head = head.split("::")[-1] or name
    return head.split(" = ")[0].split(".")[0]


def aggregate(path: str):
    """dict(per_kernel, per_family, per_host_op: Counter name -> device ms,
    device_ms, device_events, launches, host_ops (the `cpu_op` events: ATen
    and custom operators, nested ones included), span_ms (first event's
    start to the last one's end), trace: the file read)."""
    trace = find_trace(path)
    with open(trace) as f:
        doc = json.load(f)
    events = [e for e in (doc["traceEvents"] if isinstance(doc, dict) else doc)
              if e.get("ph") == "X"]
    annotations = {e["name"] for e in events if e.get("cat") in ANNOTATION_CATS}
    host_op = {e["args"]["External id"]: e["name"] for e in events
               if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    per_kernel: collections.Counter = collections.Counter()
    per_host_op: collections.Counter = collections.Counter()
    n = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e["name"] in annotations:
            continue
        ms = float(e.get("dur", 0.0)) / 1e3
        per_kernel[e["name"]] += ms
        per_host_op[host_op.get(e.get("args", {}).get("External id"), "(no host op)")] += ms
        n += 1
    per_family: collections.Counter = collections.Counter()
    for name, ms in per_kernel.items():
        per_family[family(name)] += ms
    launches = sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e["name"].startswith(LAUNCH_PREFIXES) for e in events)
    host_ops = sum(e.get("cat") == "cpu_op" for e in events)
    span_ms = ((max(e["ts"] + e.get("dur", 0.0) for e in events) - min(e["ts"] for e in events))
               / 1e3 if events else 0.0)
    return {"per_kernel": per_kernel, "per_family": per_family, "per_host_op": per_host_op,
            "device_ms": sum(per_kernel.values()), "device_events": n, "launches": launches,
            "host_ops": host_ops, "span_ms": span_ms, "trace": trace}


def main(argv=None):
    p = argparse.ArgumentParser(description="device time per kernel, family and host op")
    p.add_argument("trace", help="a trace.json, or a directory holding one")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--ops", action="store_true",
                   help="print individual kernels instead of families")
    args = p.parse_args(argv)

    agg = aggregate(args.trace)
    total = agg["device_ms"]
    print(f"trace: {agg['trace']}")
    print(f"device self-time total: {total:.3f} ms over {agg['device_events']} device events; "
          f"kernel-launch API calls {agg['launches']}; host ops {agg['host_ops']}; traced span "
          f"{agg['span_ms']:.3f} ms")
    rows = agg["per_kernel" if args.ops else "per_family"].most_common(args.top)
    for name, ms in rows:
        print(f"{ms:9.3f} ms  {100 * ms / max(total, 1e-9):5.1f}%  {name[:140]}")
    ops = agg["per_host_op"].most_common(args.top)
    print("by host op:")
    for name, ms in ops:
        print(f"{ms:9.3f} ms  {100 * ms / max(total, 1e-9):5.1f}%  {name[:140]}")
    summary = {"trace": agg["trace"], "device_ms": total,
               "device_events": agg["device_events"], "launches": agg["launches"],
               "host_ops": agg["host_ops"], "span_ms": agg["span_ms"],
               "top": [[name, ms] for name, ms in rows],
               "top_host_ops": [[name, ms] for name, ms in ops]}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
