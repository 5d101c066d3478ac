"""What the metric readers under `metrics/` share: each reader is
`read(ctx) -> value or None` over a run's readings (`serve.run`,
`train.run`), and returns None where its cell's run has nothing for it to
read (another kind of run, no traced stretch, no FLOP count). A share of
a roofline or of a peak is never 0 for want of a reading."""
from __future__ import annotations

from typing import Any, Dict, Optional

from . import trace

Ctx = Dict[str, Any]
UNITS = {"serve": "frames", "train": "samples"}


def rate(ctx: Ctx, kind: str) -> Optional[float]:
    """Frames or samples completed in the window over its seconds."""
    if ctx["kind"] != kind:
        return None
    return ctx[UNITS[kind]] / ctx["window_s"]


def host_ms(ctx: Ctx, kind: str) -> Optional[float]:
    """Mean host milliseconds of one call into the program in the window
    (the benchmark's span around `refine` or `run_step`)."""
    if ctx["kind"] != kind or not ctx["host_ms"]:
        return None
    return sum(ctx["host_ms"]) / len(ctx["host_ms"])


def device_ms_per_unit(ctx: Ctx, kind: str) -> Optional[float]:
    """Device milliseconds per frame or sample of the traced stretch."""
    tr = ctx.get("traced")
    if ctx["kind"] != kind or not tr or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] * 1e3 / ctx[f"traced_{UNITS[kind]}"]


def mfu(ctx: Ctx, kind: str) -> Optional[float]:
    """% of the configuration's peak: the reference's FLOPs per frame or
    sample times those of the window, over the window's seconds."""
    if ctx["kind"] != kind or not ctx.get("flops"):
        return None
    peak = ctx["config"]["peak_tflops"] * 1e12
    return 100.0 * ctx["flops"] * ctx[UNITS[kind]] / ctx["window_s"] / peak


def raster_roofline(ctx: Ctx, kind: str) -> Optional[float]:
    """% of the sweep's roofline: its bytes' least time at the HBM's rate
    over its device time per launch in the trace; the sweep is the fused
    rows-attrs kernel, or the tiled z/fid sweep under the parity preset."""
    if ctx["kind"] != kind or not ctx.get("traced"):
        return None
    cfg = ctx["config"]
    sweep = "z/fid" if cfg["parity"] else "attrs"
    r = ctx["traced"]["raster"][sweep]
    if not r["launches"] or r["seconds"] <= 0:
        return None
    S = cfg["zoom_crop_size"]
    nbytes = trace.raster_bytes(sweep, ctx["batch"], cfg["num_faces"], S, S, 6)
    return trace.roofline_share(nbytes, r["seconds"] / r["launches"])


def idle_share(ctx: Ctx, kind: str) -> Optional[float]:
    """% of the window in which the card's stream held none of the
    program's work: the gaps between calls (`serve.Spans`), over the
    window, both by CUDA events on the card in the untraced window. Idle
    time inside a call (the device waiting on the host between a call's
    launches) is not in it. Not the traced stretch's wall time: under the
    profiler a replay's `cudaGraphLaunch` takes tens of ms (CUPTI records
    every node of the graph), which no unprofiled call pays."""
    gaps = ctx.get("call_gaps")
    if ctx["kind"] != kind or not gaps:
        return None
    window, outside = gaps
    return 100.0 * outside / window
