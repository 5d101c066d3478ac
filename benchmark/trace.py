"""Trace arithmetic, frozen here: the device-event, launch, graph-launch
and family rules of `rnnpose_tpu_torch/tools/parse_trace.py`, the busy-time
rule of `rnnpose_tpu_torch/utils/profiling.device_busy`, and the raster
kernels' byte counts of `chip_smoke.py::_bound`.

Rules, on a `torch.profiler` Chrome trace:
* device events are the `kernel`, `gpu_memcpy` and `gpu_memset` events; a
  name that is also a user annotation's is left out (an annotation's span
  on the device covers the gaps between its kernels);
* a device event's time is its own duration: events on one stream do not
  nest. Busy time is their sum (one stream: the program runs on one);
* launches are the host's `cudaLaunchKernel*` / `cuLaunchKernel*` calls,
  graph launches its `cudaGraphLaunch*` / `cuGraphLaunch*` calls;
* a kernel's family is its base name (no `void`, template arguments,
  parameters or namespaces), then the head before ` = ` and the first `.`;
* an idle gap is the time between one device event's end and the next
  one's start; it is named by the innermost host event (operator, user
  annotation or runtime call) running at the gap's start.
"""
from __future__ import annotations

import bisect
import collections
import json
import re
from typing import Any, Dict, List

__all__ = ["DEVICE_CATS", "family", "summarize", "load", "raster_bytes", "roofline_share",
           "HBM_BYTES_PER_S", "RASTER_KERNELS"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_CATS = ("user_annotation", "gpu_user_annotation")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
GRAPH_LAUNCH_PREFIXES = ("cudaGraphLaunch", "cuGraphLaunch")
HBM_BYTES_PER_S = 3.35e12   # one H100 SXM's HBM3 (NVIDIA's data sheet)
# The raster sweeps' device kernel: attrs (rows-attrs, fused path) or z/fid
# (the tiled sweep of the non-fused path).
RASTER_KERNELS = {"attrs": "culled_sweep_kernel<true>", "z/fid": "culled_sweep_kernel<false>"}


def family(name: str) -> str:
    head = re.split(r"[<(]", name.removeprefix("void "), maxsplit=1)[0].strip()
    head = head.split("::")[-1] or name
    return head.split(" = ")[0].split(".")[0]


def _events(doc) -> List[Dict[str, Any]]:
    return [e for e in (doc["traceEvents"] if isinstance(doc, dict) else doc)
            if e.get("ph") == "X"]


def summarize(doc, top: int = 10) -> Dict[str, Any]:
    """The trace's device busy seconds and events, launches, graph launches,
    device seconds by family (the `top` largest), the raster kernels' time
    and launches, and the `top` longest idle gaps by host activity."""
    events = _events(doc)
    annotations = {e["name"] for e in events if e.get("cat") in ANNOTATION_CATS}
    device = sorted((e for e in events
                     if e.get("cat") in DEVICE_CATS and e["name"] not in annotations),
                    key=lambda e: e["ts"])
    by_family: collections.Counter = collections.Counter()
    raster = {k: [0.0, 0] for k in RASTER_KERNELS}
    for e in device:
        s = float(e.get("dur", 0.0)) / 1e6
        by_family[family(e["name"])] += s
        for k, kname in RASTER_KERNELS.items():
            if kname in e["name"]:
                raster[k][0] += s
                raster[k][1] += 1
    api = [e["name"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    host = sorted((e for e in events if e.get("cat") in HOST_CATS), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps: collections.Counter = collections.Counter()
    for a, b in zip(device, device[1:]):
        end = a["ts"] + a.get("dur", 0.0)
        gap = b["ts"] - end
        if gap <= 0:
            continue
        # innermost host event covering the gap's start: the latest-starting
        # one among those that started before it and end after it.
        name = "(no host event)"
        for i in range(bisect.bisect_right(starts, end) - 1, -1, -1):
            h = host[i]
            if h["ts"] + h.get("dur", 0.0) >= end:
                name = h["name"]
                break
            if end - h["ts"] > 5e6:  # nothing covering within 5 s
                break
        gaps[name] += gap / 1e6
    return {
        "busy_s": sum(float(e.get("dur", 0.0)) for e in device) / 1e6,
        "device_events": len(device),
        "launches": sum(n.startswith(LAUNCH_PREFIXES) for n in api),
        "graph_launches": sum(n.startswith(GRAPH_LAUNCH_PREFIXES) for n in api),
        "families": by_family.most_common(top),
        "raster": {k: {"seconds": v[0], "launches": v[1]} for k, v in raster.items()},
        "idle_gaps": gaps.most_common(top),
    }


def load(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def raster_bytes(sweep: str, B: int, F: int, h: int, w: int, D: int) -> int:
    """Bytes of one sweep call, each input read once and each output written
    once (`chip_smoke.py::_bound`): per face 64 bytes of face data and 16 of
    bbox (+ 12 D of corner attributes for the attribute sweep), per pixel 8
    of z and face id (+ 4 D of attributes)."""
    attrs = sweep == "attrs"
    per_face = 64 + 16 + (12 * D if attrs else 0)
    return B * F * per_face + B * h * w * (8 + (4 * D if attrs else 0))


def roofline_share(nbytes: int, seconds_per_launch: float) -> float:
    """% of the least time the bytes take at the HBM's rate, over the time."""
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds_per_launch
