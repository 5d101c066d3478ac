"""The `flow` kind: RAFT's optical flow through the program's graphed engine
(`rnnpose_tpu_torch.models.engine.FlowEngine`) under a closed loop of one
client.

Set-up builds the program's RAFT from the configuration (its widths, its
iterations, its precision), gives it the seed's weights
(`benchmark/gen_flow.make_weights`), makes the pair shape's program
(`prepare`: the eager warm-ups and the one capture) and sends warm-up
requests: at least `warmup_requests`, and on until `warmup_seconds` have
passed since the capture. A capture puts every graph of the process into
a slow phase (each replay ~10% slower) that ends 2 to 32 s later (PERF.md
§6); without the wait a window's p95 falls on either side of that step
from run to run. The window then sends request after request: each a new
pair of the configuration's frame size drawn on the device from the seed
(`gen_flow.make_pairs`: a smooth random texture and its copy under a seeded
translation of up to `max_shift` pixels, each frame with fresh noise),
synchronised before its clock starts, so a request's time runs from the
call to `flow` to the host read of the unpadded full-resolution flow. CUDA
events around each call give the device's gaps between calls. A seeded
reservoir keeps `check_sample` of the window's requests with their outputs
for the check. The readings carry kind `serve` (one pair is one frame), so
the serving readers take them; `model` is `raft`.

The check (`judge`), with the program's state freed: the plain reference
(`benchmark/reference/models/raft_flow.py`, f32, TF32 off) on the same
pair and weights. Random weights drive the coarse flow tens of pixels
within 32 iterations, and a free-running reference drifts from any other
run of it as the rounding of the first iterations is carried through the
lookups of the later ones; so the reference follows the program one
iteration at a time: iteration k starts from the program's own coarse
flow after iteration k - 1 (the reference's `forced`), with the
reference's own hidden state. Compared, each the largest over the sample:

* `iter_gap_px`: the mean over the 1/8 grid of |flow_prog - flow_ref| in
  grid pixels after the worst iteration (each iteration's step from the
  same coordinates); infinite if the program ran another number of
  iterations;
* `flow_up_gap_px`: the mean over the frame of |flow_prog - flow_ref| in
  pixels at full resolution (the last step, the mask head and the convex
  upsampling from the program's last coordinates);
* `corr_pyramid_f32_gap`: |bytes / f32 bytes - 1| of the correlation
  pyramid that the program's capture built (the engine's
  `corr_pyramid_bytes`, read from the levels' tensors), against the f32
  pyramid of the configuration's grid: the configuration keeps the
  pyramid and its lookup in f32. Its rounding alone moves neither number
  above: the motion encoder's first convolution takes the lookup in bf16.
  Infinite where the program reports no such count.

`free_flow_up_gap_px`, the same against the reference running free, is
reported beside them and not compared. The limits, and the readings that
set them, are in the configuration file and in PERF.md.

  python3 -m benchmark.runners.flow --workload raft-sintel-b1 --seeds 1 2 3 \
      --control_seeds 7 8 9 --faults bf16_volume iters31 instance_cnet mask_axis \
      --fault_seeds 4 5 6 [--seconds 3] [--out readings.jsonl]

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
import sys
import time
from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import gen, gen_flow, serve
from benchmark.reference.models import raft_flow as ref_flow

__all__ = ["run", "judge", "build_program", "check_flow", "FAULTS", "control_numbers",
           "f32_pyramid_bytes"]


def build_program(cfg: Dict[str, Any], device):
    """The program's RAFT of configuration `cfg`, in eval mode, on `device`."""
    from rnnpose_tpu_torch.models.raft_flow import RAFT, RAFTConfig

    return RAFT(RAFTConfig(
        hidden_dim=cfg["hidden_dim"], context_dim=cfg["context_dim"],
        corr_levels=cfg["corr_levels"], corr_radius=cfg["corr_radius"],
        mixed_precision=cfg["mixed_precision"])).to(device).eval()


def build_reference(cfg: Dict[str, Any], weights, device):
    ref_flow.exact_f32()
    model = ref_flow.RAFT(cfg["hidden_dim"], cfg["context_dim"], cfg["corr_levels"],
                          cfg["corr_radius"]).to(device).eval()
    model.load_state_dict(weights, strict=True)
    return model


class Pairs:
    """The traffic's request stream: request k of a run is the same for a
    seed."""

    def __init__(self, cfg, traffic, seed: int, device):
        self.cfg, self.t = cfg, traffic
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def next(self):
        i1, i2, _ = gen_flow.make_pairs(self.t["batch"], self.cfg["height"], self.cfg["width"],
                                        self.t["max_shift"], self.t["noise"], self.gen)
        return i1, i2


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
        # On the card: the host's own pass over the 893k values took 2-3 ms.
        failed += int(not bool(torch.isfinite(out.flow).all()))
        res.offer(lambda: dict(image1=i1, image2=i2, flow=out.flow,
                               flow_history=out.flow_history))
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

    readings = dict(kind="serve", model="raft", setup_s=setup_s, window_s=window_s,
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

        readings["traced"] = ctx["profile"](traced)
        readings["traced_frames"] = len(drawn) * B
    del engine, model, out, pairs
    return dict(readings=readings, samples=res.items, weights=weights)


@torch.no_grad()
def check_flow(reference, samples, iters: int) -> Dict[str, float]:
    """The flow numbers of `samples` against `reference` (see the module
    docstring)."""
    up, it, free = [], [], []
    for s in samples:
        hist = s["flow_history"]
        r = reference(s["image1"], s["image2"], iters, forced=hist)
        up.append(float((s["flow"] - r["flow"]).norm(dim=-1).mean()))
        if hist.shape != r["flow_history"].shape:
            it.append(float("inf"))
        else:
            it.append(float((hist - r["flow_history"]).norm(dim=-1).flatten(2).mean(-1).max()))
        r = reference(s["image1"], s["image2"], iters)
        free.append(float((s["flow"] - r["flow"]).norm(dim=-1).mean()))

    def worst(v):
        v = [x if x == x else float("inf") for x in v]  # NaN is a failure
        return max(v)
    return {"flow_up_gap_px": worst(up), "iter_gap_px": worst(it),
            "free_flow_up_gap_px": worst(free), "compared": len(samples),
            "items": {"flow_up": up, "iter": it, "free_flow_up": free}}


def f32_pyramid_bytes(cfg: Dict[str, Any], batch: int) -> int:
    """Bytes of the f32 correlation pyramid of the configuration's frames:
    the 1/8 grid of the frames padded to a multiple of 8, each level
    pooled 2 x 2 with an odd last row or column dropped."""
    h, w = -(-cfg["height"] // 8), -(-cfg["width"] // 8)
    total, hl, wl = 0, h, w
    for _ in range(cfg["corr_levels"]):
        total += batch * h * w * hl * wl * 4
        hl, wl = hl // 2, wl // 2
    return total


def pyramid_gap(cfg: Dict[str, Any], batch: int, counted: Dict[str, int]) -> float:
    """The largest |bytes / f32 bytes - 1| over the programs' pyramids;
    infinite without a count."""
    want = f32_pyramid_bytes(cfg, batch)
    return max((abs(n / want - 1.0) for n in counted.values()), default=float("inf"))


def judge(ctx, got, trace: bool):
    """(the flow numbers of `check_flow`, FLOPs per frame or None): the
    FLOPs are FlopCounterMode's count over the reference's forward at the
    cell's batch, frame size and iterations, taken in traced runs only."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    reference = build_reference(cfg, got["weights"], dev)
    flops = None
    if trace:
        s = got["samples"][0]
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            reference(s["image1"], s["image2"], cfg["iters"])
        flops = counter.get_total_flops() / s["image1"].shape[0]
    numbers = check_flow(reference, got["samples"], cfg["iters"])
    numbers["corr_pyramid_f32_gap"] = pyramid_gap(cfg, traffic["batch"],
                                                  got["readings"]["corr_pyramid_bytes"])
    del reference
    return numbers, flops


# ---- faults and the control (the readings that set the limits) ----------


def _bf16_volume(model, flow):
    """The correlation pyramid built and kept in bf16: half the bytes that
    the lookup gathers from."""
    from rnnpose_tpu_torch.models import raft_flow
    from rnnpose_tpu_torch.ops import corr as corr_ops

    def build(f1, f2, levels):
        p = corr_ops.build_corr_pyramid(f1.to(torch.bfloat16), f2.to(torch.bfloat16), levels)
        return corr_ops.CorrPyramid(tuple(lv.to(torch.bfloat16) for lv in p.levels))

    raft_flow.corr_ops = SimpleNamespace(build_corr_pyramid=build,
                                         corr_lookup=corr_ops.corr_lookup)
    return flow


def _iters31(model, flow):
    """One iteration fewer than asked for."""
    return lambda i1, i2, iters: flow(i1, i2, iters - 1)


def _instance_cnet(model, flow):
    """Instance norm in place of the context encoder's batch norms."""
    from rnnpose_tpu_torch.models.raft import BatchNorm, InstanceNorm

    for m in list(model.cnet.modules()):
        for name, child in list(m.named_children()):
            if isinstance(child, BatchNorm):
                setattr(m, name, InstanceNorm())
    return flow


def _mask_axis(model, flow):
    """The upsampling mask's softmax over one of the 8 x 8 sub-pixel axes
    in place of the 9 taps."""
    from rnnpose_tpu_torch.models import raft_flow
    from rnnpose_tpu_torch.ops.upsample import convex_upsample

    def upsample(f, mask, factor=8):
        B, h, w, _ = f.shape
        m = mask.reshape(B, h, w, 9, factor, factor).transpose(3, 4).reshape(B, h, w, -1)
        return convex_upsample(f, m, factor)

    raft_flow.convex_upsample = upsample
    return flow


FAULTS = {"bf16_volume": _bf16_volume, "iters31": _iters31, "instance_cnet": _instance_cnet,
          "mask_axis": _mask_axis}


@contextlib.contextmanager
def _restored():
    """The program's module attributes that faults replace, put back."""
    from rnnpose_tpu_torch.models import raft_flow

    saved = raft_flow.corr_ops, raft_flow.convex_upsample
    try:
        yield
    finally:
        raft_flow.corr_ops, raft_flow.convex_upsample = saved


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448), in f32."""
    t32 = t.to(torch.float32)
    scale = t32.abs().amax().clamp(min=1e-30) / 448.0
    return (t32 / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@torch.no_grad()
def control_numbers(cfg, traffic, seed: int, device) -> Dict[str, float]:
    """The flow numbers of the control in the program's place: the
    reference with every convolution's input and weight rounded to float8,
    on the cell's first `check_sample` pairs of the seed's stream."""
    s = gen.seeds(seed)
    like = ref_flow.RAFT(cfg["hidden_dim"], cfg["context_dim"], cfg["corr_levels"],
                         cfg["corr_radius"]).to("meta")
    weights = gen_flow.make_weights(like, s["weights"], device)
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
    numbers = check_flow(build_reference(cfg, weights, device), samples, cfg["iters"])
    numbers["corr_pyramid_f32_gap"] = 0.0  # the reference's CorrBlock is f32 throughout
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
    p.add_argument("--out")
    args = p.parse_args(argv)
    _set_caches()
    spec = load_spec(ROOT)
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
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
    for seed in args.control_seeds:
        n = control_numbers(cfg, traffic, seed, dev)
        n.pop("items")
        emit(dict(run="control", seed=seed, numbers=n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
