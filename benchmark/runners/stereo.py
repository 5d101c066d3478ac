"""The `stereo` kind: RAFT-Stereo's disparity through the program's graphed
engine (`rnnpose_tpu_torch.models.engine.FlowEngine` over
`models/raft_stereo.RAFTStereo`) under a closed loop of one client.

Set-up builds the program's RAFT-Stereo from the configuration (its widths,
its iterations, its precision), gives it the seed's weights
(`benchmark/gen_flow.make_weights`, by name), makes the pair shape's program
(`prepare`: the eager warm-ups and the one capture) and sends warm-up
requests: at least `warmup_requests`, and on until `warmup_seconds` have
passed since the capture (the slow start after a capture, PERF.md §6). The
window then sends request after request: each a new rectified pair of the
configuration's frame size drawn on the device from the seed
(`gen_stereo.make_pairs`: a smooth random texture and its copy under a
seeded whole-pixel disparity of up to `max_disp` pixels, each frame with
fresh noise), synchronised before its clock starts, so a request's time
runs from the call to `flow` to the host read of the unpadded
full-resolution x-flow. CUDA events around each call give the device's gaps
between calls. A seeded reservoir keeps `check_sample` of the window's
requests with their outputs for the check, and with the correlation volume
that the request's forward built, at `VOLUME_ROWS` rows of the 1/4 grid
(`VolumeProbe`: the program's features of both frames and its pyramid's
levels there). The readings carry kind `serve`
(one pair is one frame), so the serving readers take them; `model` is
`raft_stereo`. A traced run profiles `trace_requests` more requests and
keeps, beside the harness's summary, the 1D lookup kernel's device seconds
and launches (`lookup1d_roofline`).

The check (`judge`), with the program's state freed: the plain reference
(`benchmark/reference/models/raft_stereo.py`, f32, TF32 off) on the same
pair and weights, following the program one iteration at a time as the
`flow` kind's check does (iteration k starts from the program's own coarse
x-flow after iteration k - 1, with the reference's own hidden states).
Compared, each the largest over the sample:

* `iter_gap_px`: the mean over the 1/4 grid of |x_prog - x_ref| in grid
  pixels after the worst iteration; infinite if the program ran another
  number of iterations;
* `disp_up_gap_px`: the mean over the frame of |x_prog - x_ref| in pixels
  at full resolution (the last step, the mask head and the convex
  upsampling from the program's last coordinates);
* `corr_pyramid_f32_gap`: |bytes / f32 bytes - 1| of the correlation
  pyramid that the program's capture built (the engine's
  `corr_pyramid_bytes`), against the f32 bytes of the levels of
  `CorrBlock1D` that its lookup reads (`f32_pyramid_bytes`); infinite where
  the program reports no such count;
* `corr_volume_gap`: the values of that volume, as the timed request built
  them, at the probe's rows: the largest |program - reference| over a
  level, over the largest |reference| of the level, where the reference is
  `CorrBlock1D` in f32 (TF32 off) on the program's own features of those
  rows; the largest over the levels and the sample, infinite without a
  probe. A volume computed in a lower precision, whatever it is stored in,
  reads that precision's rounding here.

Unlike the `flow` kind's, the check runs no free-running reference beside
them: an f32 forward with TF32 off at Middlebury's frame takes about 20 s on
an H100, and the check keeps under a minute. The limits, and the readings
that set them, are in the configuration file and in PERF.md.

  python3 -m benchmark.runners.stereo --workload raft-stereo-middlebury-b1 \
      --seeds 1 2 3 --control_seeds 7 8 --faults bf16_volume bf16_volume_f32 iters31 \
      coarse_swap no_interp --fault_seeds 4 5 [--seconds 3] [--warmup_seconds 0] [--out f.jsonl]

prints those readings as JSON lines: the program's runs (the lower
readings), the control's (the reference in the program's place with every
convolution's input and weight rounded to float8 e4m3, one precision below
the configuration's bf16) and the program's with each of `FAULTS` planted;
the harness's own runs never run it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import gen, gen_flow, gen_stereo, serve, trace
from benchmark.reference.models import raft_stereo as ref_stereo
from benchmark.runners.flow import _fp8_round

__all__ = ["run", "judge", "build_program", "check_stereo", "FAULTS", "control_numbers",
           "f32_pyramid_bytes", "lookup1d_bytes", "lookup1d_roofline", "LOOKUP1D_KERNEL",
           "VolumeProbe", "volume_gap"]

LOOKUP1D_KERNEL = "corr_lookup_1d_kernel"  # the 1D lookup's device kernel, by name
GRID = 4      # the finest GRU grid: 1/4 of the padded frame
DIVISOR = 32  # the padder's `divis_by`
VOLUME_ROWS = 8  # rows of the 1/4 grid whose correlation volume the check compares


def build_program(cfg: Dict[str, Any], device):
    """The program's RAFT-Stereo of configuration `cfg`, in eval mode, on
    `device` (ImportError from a program without it)."""
    from rnnpose_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig

    return RAFTStereo(RAFTStereoConfig(
        hidden_dim=cfg["hidden_dim"], corr_levels=cfg["corr_levels"],
        corr_radius=cfg["corr_radius"], mixed_precision=cfg["mixed_precision"])).to(device).eval()


def _reference_model(cfg: Dict[str, Any]):
    return ref_stereo.RAFTStereo(cfg["hidden_dim"], cfg["corr_levels"], cfg["corr_radius"],
                                 cfg["cnet_norm"], cfg["n_downsample"])


def build_reference(cfg: Dict[str, Any], weights, device):
    ref_stereo.exact_f32()
    model = _reference_model(cfg).to(device).eval()
    model.load_state_dict(weights, strict=True)
    return model


class Pairs:
    """The traffic's request stream: request k of a run is the same for a
    seed."""

    def __init__(self, cfg, traffic, seed: int, device):
        self.cfg, self.t = cfg, traffic
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def next(self):
        i1, i2, _ = gen_stereo.make_pairs(self.t["batch"], self.cfg["height"],
                                          self.cfg["width"], self.t["max_disp"],
                                          self.t["noise"], self.gen)
        return i1, i2


class VolumeProbe:
    """The program's correlation volume, watched where its forward builds it:
    in place of `models/raft_stereo.corr_ops` (faults planted there
    included), its pyramid builder, which keeps what `rows()` reads. A
    build under graph capture keeps its features and levels by reference: a
    replay writes its request's values into those same tensors, so after
    each request `rows()` reads that request's volume (holding them keeps
    the bf16 features of both frames at the 1/4 grid allocated in the
    graph's pool past the pyramid's build). An eager build (the warm-ups,
    the CPU) copies its rows at once, so that no eager tensor outlives its
    call.

    with VolumeProbe() as probe: ... probe.rows()
    """

    def __init__(self):
        self.ops, self.captured, self.copied = None, None, None

    def __enter__(self):
        from rnnpose_tpu_torch.models import raft_stereo

        self.ops, raft_stereo.corr_ops = raft_stereo.corr_ops, self
        return self

    def __exit__(self, *exc):
        from rnnpose_tpu_torch.models import raft_stereo

        raft_stereo.corr_ops, self.captured, self.copied = self.ops, None, None

    def __getattr__(self, name):
        return getattr(self.ops, name)

    def build_corr_pyramid_1d(self, fmap1, fmap2, levels):
        pyramid = self.ops.build_corr_pyramid_1d(fmap1, fmap2, levels)
        if fmap1.is_cuda and torch.cuda.is_current_stream_capturing():
            self.captured = (fmap1, fmap2, pyramid.levels)
        else:
            self.captured, self.copied = None, _volume_rows(fmap1, fmap2, pyramid.levels)
        return pyramid

    def rows(self) -> Optional[Dict[str, Any]]:
        """Copies of the last volume at `VOLUME_ROWS` rows spread over the
        grid's height: the features f1, f2 (B, n, W, C) and each level
        (B, n, W, w_i); None before a volume was built."""
        return _volume_rows(*self.captured) if self.captured is not None else self.copied


def _volume_rows(f1, f2, levels) -> Dict[str, Any]:
    B, H, W, _ = f1.shape
    idx = torch.linspace(0, H - 1, min(VOLUME_ROWS, H), device=f1.device).round().long()
    return dict(f1=f1[:, idx].clone(), f2=f2[:, idx].clone(),
                levels=[lv.reshape(B, H, W, -1)[:, idx].clone() for lv in levels])


def volume_gap(volume: Optional[Dict[str, Any]], cfg: Dict[str, Any]) -> float:
    """The largest over the levels of max |program - reference| / max
    |reference| at the probe's rows, the reference `CorrBlock1D` in f32 on
    the program's features there (infinite without a volume or with another
    number of levels)."""
    if volume is None or len(volume["levels"]) != cfg["corr_levels"]:
        return float("inf")
    f1, f2 = (volume[k].permute(0, 3, 1, 2).float() for k in ("f1", "f2"))
    want = ref_stereo.CorrBlock1D(f1, f2, cfg["corr_levels"], cfg["corr_radius"]).corr_pyramid
    gaps = []
    for got, ref in zip(volume["levels"], want):
        if ref.numel() != got.numel():
            return float("inf")
        ref = ref.reshape(got.shape)
        gaps.append(float((got.float() - ref).abs().max() / ref.abs().max()))
    return max(g if g == g else float("inf") for g in gaps)


def profile(fn) -> Dict[str, Any]:
    """fn() under torch.profiler, as `benchmark.run.profile`: the trace's
    summary (`trace.summarize`) and the traced window's seconds, and the 1D
    lookup kernel's device seconds and launches (`lookup1d`)."""
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
        doc = trace.load(path)
    summary = trace.summarize(doc)
    summary["window_s"] = window
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    lookups = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and LOOKUP1D_KERNEL in e["name"]]
    summary["lookup1d"] = {"seconds": sum(float(e.get("dur", 0.0)) for e in lookups) / 1e6,
                           "launches": len(lookups)}
    return summary


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    """Set-up, window and (with ctx["trace"]) a traced stretch; the
    readings, and the reservoir for the check."""
    from rnnpose_tpu_torch.models.engine import FlowEngine

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    s = gen.seeds(ctx["seed"])
    B, iters = traffic["batch"], cfg["iters"]
    serve._reset_peak(dev)
    model = build_program(cfg, dev)
    weights = gen_flow.make_weights(model, s["weights"], dev)
    model.load_state_dict(weights, strict=True)
    engine = FlowEngine(model)
    pairs = Pairs(cfg, traffic, s["requests"], dev)
    flow = engine.flow
    if "fault" in ctx:  # the control plants faults in the timed path here
        flow = ctx["fault"](model, flow)
    with VolumeProbe() as probe:  # the check reads the volume each request built
        t_built = time.perf_counter()
        first = pairs.next()
        engine.prepare(*first, iters)
        serve._sync(dev)
        t_prepared = time.perf_counter()
        warmups = 0
        while (warmups < traffic["warmup_requests"]
               or time.perf_counter() - t_prepared < traffic["warmup_seconds"]):
            flow(*pairs.next(), iters).flow.cpu()
            warmups += 1
        serve._sync(dev)
        captures = engine.graph_captures
        setup_s = time.perf_counter() - ctx["t_start"]
        print(f"setup: {t_built - ctx['t_start']:.3f} s to the built model, prepare (warm-ups, "
              f"capture) {t_prepared - t_built:.3f} s, {warmups} warm-up requests "
              f"{setup_s - (t_prepared - ctx['t_start']):.3f} s", file=sys.stderr)

        res = serve._Reservoir(traffic["check_sample"], s["check"])
        lat_ms: List[float] = []
        host_ms: List[float] = []
        failed = 0
        spans = serve.Spans(dev)
        t0 = time.perf_counter()
        spans.open()
        while time.perf_counter() - t0 < ctx["seconds"]:
            i1, i2 = pairs.next()
            serve._sync(dev)
            t_req = time.perf_counter()
            spans.begin()
            out = flow(i1, i2, iters)
            spans.end()
            t_ret = time.perf_counter()
            out.flow.cpu()
            t_done = time.perf_counter()
            lat_ms.append((t_done - t_req) * 1e3)
            host_ms.append((t_ret - t_req) * 1e3)
            failed += int(not bool(torch.isfinite(out.flow).all()))
            res.offer(lambda: dict(image1=i1, image2=i2, flow=out.flow,
                                   flow_history=out.flow_history, volume=probe.rows()))
        spans.close()
        serve._sync(dev)
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        q = np.quantile(lat_ms, [0.05, 0.5, 0.95]) if lat_ms else [float("nan")] * 3
        print(f"window: {len(lat_ms)} requests in {window_s:.3f} s; request ms p5 {q[0]:.3f} "
              f"p50 {q[1]:.3f} p95 {q[2]:.3f} max {max(lat_ms):.3f}; host ms per call mean "
              f"{sum(host_ms) / len(host_ms):.3f}; mean request ms by tenth of the window "
              f"{[round(float(np.mean(c)), 2) for c in np.array_split(lat_ms, 10) if len(c)]}",
              file=sys.stderr)

        readings = dict(kind="serve", model="raft_stereo", setup_s=setup_s, window_s=window_s,
                        requests=len(lat_ms), frames=B * len(lat_ms), latencies_ms=lat_ms,
                        host_ms=host_ms, failed=failed, memory_peak_bytes=peak,
                        new_captures=engine.graph_captures - captures, batch=B,
                        call_gaps=spans.gaps(), graph_nodes=dict(engine.graph_nodes),
                        corr_pyramid_bytes=dict(getattr(engine, "corr_pyramid_bytes", {})))
        if ctx["trace"]:
            drawn = [pairs.next() for _ in range(traffic["trace_requests"])]
            serve._sync(dev)

            def traced():
                for i1, i2 in drawn:
                    with record_function("bench/request"):
                        out = flow(i1, i2, iters)
                    with record_function("bench/host_read"):
                        out.flow.cpu()

            readings["traced"] = profile(traced)
            readings["traced_frames"] = len(drawn) * B
            readings["traced_lookups"] = len(drawn) * iters
        del engine, model, out, pairs
        return dict(readings=readings, samples=res.items, weights=weights)


@torch.no_grad()
def check_stereo(reference, samples, cfg: Dict[str, Any]) -> Dict[str, float]:
    """The disparity numbers of `samples` against `reference` (see the
    module docstring), each the largest over the samples (NaN a failure)."""
    up, it, vol = [], [], []
    for s in samples:
        hist = s["flow_history"]
        r = reference(s["image1"], s["image2"], cfg["iters"], forced=hist)
        up.append(float((s["flow"] - r["flow"]).abs().mean()))
        it.append(float((hist - r["flow_history"]).abs().flatten(2).mean(-1).max())
                  if hist.shape == r["flow_history"].shape else float("inf"))
        vol.append(volume_gap(s.get("volume"), cfg))

    def worst(v):
        return max(x if x == x else float("inf") for x in v)
    return {"disp_up_gap_px": worst(up), "iter_gap_px": worst(it),
            "corr_volume_gap": worst(vol), "compared": len(samples),
            "items": {"disp_up": up, "iter": it, "volume": vol}}


def _grid(cfg: Dict[str, Any]):
    """The 1/4 grid (h, w) of the frames padded to a multiple of 32."""
    return (-(-cfg["height"] // DIVISOR) * DIVISOR // GRID,
            -(-cfg["width"] // DIVISOR) * DIVISOR // GRID)


def f32_pyramid_bytes(cfg: Dict[str, Any], batch: int) -> int:
    """Bytes of the f32 levels of `CorrBlock1D` that the lookup reads: per
    position of the 1/4 grid, its row of w correlations pooled by two along
    the row per level (an odd last column dropped)."""
    h, w = _grid(cfg)
    return sum(batch * h * w * (w >> i) * 4 for i in range(cfg["corr_levels"]))


def pyramid_gap(cfg: Dict[str, Any], batch: int, counted: Dict[str, int]) -> float:
    """The largest |bytes / f32 bytes - 1| over the programs' pyramids;
    infinite without a count."""
    want = f32_pyramid_bytes(cfg, batch)
    return max((abs(n / want - 1.0) for n in counted.values()), default=float("inf"))


def lookup1d_bytes(cfg: Dict[str, Any], batch: int) -> int:
    """Bytes of one 1D lookup, each read once and each written once: every
    query's x coordinate (4 bytes), the 2r+2 contiguous f32 values of its
    row at each level that its taps can reach (the level's width at most),
    and its L (2r+1) f32 outputs."""
    h, w = _grid(cfg)
    Q, r, L = batch * h * w, cfg["corr_radius"], cfg["corr_levels"]
    return Q * (4 + sum(min(2 * r + 2, w >> i) * 4 for i in range(L)) + L * (2 * r + 1) * 4)


def lookup1d_roofline(ctx) -> float:
    """% of the 1D lookup kernel's roofline: its bytes' least time at the
    HBM's rate over its device time a launch in the traced requests; None
    without a traced run or a launch of the kernel."""
    tr = ctx.get("traced")
    if ctx["kind"] != "serve" or ctx.get("model") != "raft_stereo" or not tr:
        return None
    got = tr.get("lookup1d")
    if not got or not got["launches"] or got["seconds"] <= 0:
        return None
    nbytes = lookup1d_bytes(ctx["config"], ctx["batch"])
    return trace.roofline_share(nbytes, got["seconds"] / got["launches"])


def judge(ctx, got, trace_on: bool):
    """(the disparity numbers of `check_stereo`, FLOPs per frame or None):
    the FLOPs are FlopCounterMode's count over the reference's forward at
    the cell's batch, frame size and iterations, taken in traced runs
    only."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    reference = build_reference(cfg, got["weights"], dev)
    flops = None
    if trace_on:
        s = got["samples"][0]
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            reference(s["image1"], s["image2"], cfg["iters"])
        flops = counter.get_total_flops() / s["image1"].shape[0]
    numbers = check_stereo(reference, got["samples"], cfg)
    numbers["corr_pyramid_f32_gap"] = pyramid_gap(cfg, traffic["batch"],
                                                  got["readings"]["corr_pyramid_bytes"])
    del reference
    return numbers, flops


# ---- faults and the control (the readings that set the limits) ----------


def _bf16_volume(model, flow):
    """The correlation volume built and kept in bf16: half the bytes that
    the lookup gathers from."""
    from rnnpose_tpu_torch.models import raft_stereo
    from rnnpose_tpu_torch.ops import corr as corr_ops

    def build(f1, f2, levels):
        p = corr_ops.build_corr_pyramid_1d(f1.to(torch.bfloat16), f2.to(torch.bfloat16), levels)
        return corr_ops.CorrPyramid(tuple(lv.to(torch.bfloat16) for lv in p.levels))

    raft_stereo.corr_ops = SimpleNamespace(build_corr_pyramid_1d=build,
                                           corr_lookup_1d=corr_ops.corr_lookup_1d)
    return flow


def _bf16_volume_f32(model, flow):
    """The correlation volume computed in bf16 and stored in f32: the f32
    levels' bytes, a bf16 matmul's values."""
    from rnnpose_tpu_torch.models import raft_stereo
    from rnnpose_tpu_torch.ops import corr as corr_ops

    def build(f1, f2, levels):
        B, H, W, C = f1.shape
        corr = torch.bmm(f1.reshape(B * H, W, C).to(torch.bfloat16),
                         f2.reshape(B * H, W, C).to(torch.bfloat16).transpose(1, 2))
        out = [(corr.float() / C ** 0.5).reshape(B * H * W, 1, W)]
        for _ in range(levels - 1):
            w2 = out[-1].shape[-1] // 2
            out.append(out[-1][..., :2 * w2].reshape(-1, 1, w2, 2).mean(dim=-1))
        return corr_ops.CorrPyramid(tuple(out))

    raft_stereo.corr_ops = SimpleNamespace(build_corr_pyramid_1d=build,
                                           corr_lookup_1d=corr_ops.corr_lookup_1d)
    return flow


def _iters31(model, flow):
    """One iteration fewer than asked for."""
    return lambda i1, i2, iters: flow(i1, i2, iters - 1)


def _coarse_swap(model, flow):
    """gru16 before gru32 (from gru32's old state), then gru32 from gru16's
    new one: the coarse GRUs' order swapped."""
    from rnnpose_tpu_torch.models.raft_stereo import interp, pool2x

    ub = model.update_block

    def coarse(net, ctx):
        net16 = ub.gru16(net[1], *ctx[1], pool2x(net[0]), interp(net[2], net[1]))
        net32 = ub.gru32(net[2], *ctx[2], pool2x(net16))
        return [net[0], net16, net32]

    ub.coarse = coarse
    return flow


def _no_interp(model, flow):
    """The coarse-to-fine interpolations dropped: each finer GRU reads zeros
    where the coarser state, interpolated up, was."""
    from rnnpose_tpu_torch.models import raft_stereo

    raft_stereo.interp = lambda x, dest: x.new_zeros(x.shape[:2] + dest.shape[2:])
    return flow


FAULTS = {"bf16_volume": _bf16_volume, "bf16_volume_f32": _bf16_volume_f32,
          "iters31": _iters31, "coarse_swap": _coarse_swap, "no_interp": _no_interp}


@contextlib.contextmanager
def _restored():
    """The program's module attributes that faults replace, put back."""
    from rnnpose_tpu_torch.models import raft_stereo

    saved = raft_stereo.corr_ops, raft_stereo.interp
    try:
        yield
    finally:
        raft_stereo.corr_ops, raft_stereo.interp = saved


@torch.no_grad()
def control_numbers(cfg, traffic, seed: int, device) -> Dict[str, float]:
    """The disparity numbers of the control in the program's place: the
    reference with every convolution's input and weight rounded to float8,
    on the cell's first `check_sample` pairs of the seed's stream."""
    s = gen.seeds(seed)
    weights = gen_flow.make_weights(_reference_model(cfg).to("meta"), s["weights"], device)
    control = build_reference(cfg, weights, device)
    for m in control.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.copy_(_fp8_round(m.weight))
            m.register_forward_pre_hook(lambda mod, args: (_fp8_round(args[0]),))
    pairs = Pairs(cfg, traffic, s["requests"], device)
    samples = []
    for _ in range(traffic["check_sample"]):
        i1, i2 = pairs.next()
        out = control(i1, i2, cfg["iters"])
        samples.append(dict(image1=i1, image2=i2, **out))
    del control
    numbers = check_stereo(build_reference(cfg, weights, device), samples, cfg)
    # The reference's CorrBlock1D is f32 throughout.
    numbers["corr_pyramid_f32_gap"] = numbers["corr_volume_gap"] = 0.0
    return numbers


def main(argv=None) -> int:
    from benchmark.run import ROOT, _set_caches, run_cell
    from benchmark.spec import load_spec

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    p.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--warmup_seconds", type=float, help="in place of the traffic's")
    p.add_argument("--out")
    args = p.parse_args(argv)
    _set_caches()
    spec = load_spec(ROOT)
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    if args.warmup_seconds is not None:
        traffic_of = spec.traffic
        spec.traffic = lambda name: dict(traffic_of(name), warmup_seconds=args.warmup_seconds)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    runs = [(None, s) for s in args.seeds] + [(f, s) for f in args.faults
                                               for s in args.fault_seeds]
    for fault, seed in runs:
        hooks = {} if fault is None else {"fault": FAULTS[fault]}
        with _restored():
            res = run_cell(spec, args.workload, seed, args.seconds, False, dev,
                           t_start=time.perf_counter(), hooks=hooks)
        emit(dict(run="fault" if fault else "program", fault=fault, seed=seed,
                  correct=res["correct"], numbers=res["numbers"],
                  metrics={k: v["value"] for k, v in res["metrics"].items()}))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for seed in args.control_seeds:
        n = control_numbers(cfg, traffic, seed, dev)
        n.pop("items")
        emit(dict(run="control", seed=seed, numbers=n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
