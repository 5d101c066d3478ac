"""Serving cells: `InferenceEngine.refine` under a closed loop of one client.

Set-up builds the scene and the weights from the seed, the program's model
and engine, makes the class's program (`prepare`: `encode_3d`, the eager
warm-ups and the one capture) and replays the traffic's warm-up requests.
The window then sends request after request. Each one is drawn on the
device from the seed (a fresh rigid jitter of the scene's initial poses,
plus `chain` times the previous request's output pose, and fresh image
noise) and synchronised before its clock starts, so a request's time runs
from the call to `refine` to the host read of its pose and holds none of
the generator's work; the window's rate holds it, as a client's frames
take their time. CUDA events around each call give the device's gaps
between calls (`readers.idle_share`). A seeded reservoir keeps
`check_sample` of the window's requests with their outputs for the
reference (`check.check_serving`). The traced stretch's requests are
drawn before the profiler starts.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from . import build, check, gen
from .reference.geometry.se3 import se3_expm

__all__ = ["Requests", "Spans", "run", "judge"]


class Requests:
    """The traffic's request stream over a scene: request k of a run is the
    same for a seed (and the previous outputs)."""

    def __init__(self, traffic: Dict[str, Any], scene: gen.Scene, seed: int):
        self.t = traffic
        self.scene = scene
        self.gen = torch.Generator(device=scene.image.device).manual_seed(seed)
        # se3_expm's twist is (translation, rotation).
        self.scale = torch.tensor([traffic["jitter_trans"]] * 3 + [traffic["jitter_rot"]] * 3,
                                  device=scene.image.device)

    def next(self, prev_pose=None):
        s, dev = self.scene, self.scene.image.device
        B = s.image.shape[0]
        xi = torch.randn(B, 6, generator=self.gen, device=dev) * self.scale
        T = se3_expm(xi) @ s.T_init
        if self.t["chain"] and prev_pose is not None:
            T = T + self.t["chain"] * prev_pose
        noise = torch.rand(s.image.shape, generator=self.gen, device=dev)
        image = (s.image + self.t["image_noise"] * noise).clamp(0.0, 1.0)
        return T, image


class _Reservoir:
    """A seeded uniform sample of `n` of the window's requests."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.items, self.seen = n, np.random.default_rng(seed), [], 0

    def offer(self, make):
        k = self.seen
        self.seen += 1
        if len(self.items) < self.n:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, k + 1))
            if j < self.n:
                self.items[j] = make()


class Spans:
    """CUDA events around each call into the program in a window, and at
    the window's ends: `gaps()` is (the seconds of the window by the
    device's clock, the seconds outside every call's span), or None off
    the card. A call's span runs from the device reaching its first work
    to its last, so a gap is time in which the stream held none of the
    program's work."""

    def __init__(self, dev):
        self.on = dev.type == "cuda"
        self.events: List[Any] = []

    def _mark(self):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    open = close = begin = end = _mark

    def gaps(self):
        if not self.on or len(self.events) < 4:
            return None
        torch.cuda.synchronize()
        ev = self.events
        window = ev[0].elapsed_time(ev[-1]) / 1e3
        inside = sum(ev[i].elapsed_time(ev[i + 1]) for i in range(1, len(ev) - 1, 2)) / 1e3
        return window, window - inside


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    """Set-up, window and (with ctx["trace"]) a traced stretch; returns the
    readings the harness turns into metrics, and the reservoir for the
    check."""
    from rnnpose_tpu_torch.models.engine import InferenceEngine

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    s = gen.seeds(ctx["seed"])
    B = traffic["batch"]
    mods = build.side("program")
    scene = gen.make_scene(cfg, B, s["scene"], dev)
    _reset_peak(dev)  # the scene's render is the benchmark's, not the program's
    model = build.build_model(mods, cfg, dev).eval()
    weights = gen.make_weights(model, s["weights"], dev)
    build.load_weights(model, weights)
    engine = InferenceEngine(model)
    base = gen.as_inputs(mods, scene)
    cls = cfg["name"]
    requests = Requests(traffic, scene, s["requests"])
    refine = engine.refine
    if "fault" in ctx:  # the tests plant faults in the timed path here
        refine = ctx["fault"](refine, engine)

    def request(T, image):
        return refine(cls, base._replace(T_init=T, image=image))

    t_built = time.perf_counter()
    engine.prepare(cls, base)
    _sync(dev)
    t_prepared = time.perf_counter()
    prev = None
    for _ in range(traffic["warmup_requests"]):
        prev = request(*requests.next(prev))["Ti_pred"]
    _sync(dev)
    captures = engine.graph_captures
    setup_s = time.perf_counter() - ctx["t_start"]
    print(f"setup: {t_built - ctx['t_start']:.3f} s to the built model and scene, prepare "
          f"(encode_3d, warm-ups, capture) {t_prepared - t_built:.3f} s, warm-up requests "
          f"{setup_s - (t_prepared - ctx['t_start']):.3f} s", file=sys.stderr)

    res = _Reservoir(traffic["check_sample"], s["check"])
    lat_ms: List[float] = []
    host_ms: List[float] = []
    failed = 0
    spans = Spans(dev)
    t0 = time.perf_counter()
    spans.open()
    while time.perf_counter() - t0 < ctx["seconds"]:
        T, image = requests.next(prev)
        _sync(dev)
        t_req = time.perf_counter()
        spans.begin()
        out = request(T, image)
        spans.end()
        t_ret = time.perf_counter()
        pose = out["Ti_pred"].cpu()
        t_done = time.perf_counter()
        lat_ms.append((t_done - t_req) * 1e3)
        host_ms.append((t_ret - t_req) * 1e3)
        failed += int(not bool(torch.isfinite(pose).all()))
        prev = out["Ti_pred"]
        res.offer(lambda: dict(T_init=T, image=image, Ti_pred=out["Ti_pred"],
                               Ti_history=out["refiner"].Ti_history,
                               Tij_history=out["refiner"].Tij_history,
                               flow_history=out["refiner"].flow_history))
    spans.close()
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    new_captures = engine.graph_captures - captures
    q = np.quantile(lat_ms, [0.05, 0.5, 0.95]) if lat_ms else [float("nan")] * 3
    print(f"window: {len(lat_ms)} requests in {window_s:.3f} s; request ms p5 {q[0]:.3f} "
          f"p50 {q[1]:.3f} p95 {q[2]:.3f} max {max(lat_ms):.3f}; host ms per call mean "
          f"{sum(host_ms) / len(host_ms):.3f}; mean request ms by tenth of the window "
          f"{[round(float(np.mean(c)), 2) for c in np.array_split(lat_ms, 10) if len(c)]}",
          file=sys.stderr)

    readings = dict(kind="serve", setup_s=setup_s, window_s=window_s, requests=len(lat_ms),
                    frames=B * len(lat_ms), latencies_ms=lat_ms, host_ms=host_ms,
                    failed=failed, memory_peak_bytes=peak, new_captures=new_captures,
                    encode_3d_calls=engine.encode_3d_calls, batch=B,
                    call_gaps=spans.gaps())
    if ctx["trace"]:
        n = traffic["trace_requests"]
        # Drawn before the profiler starts, with no chain: each request
        # still waits for the last, whose pose it reads back.
        drawn = [requests.next() for _ in range(n)]
        _sync(dev)

        def traced():
            for T, image in drawn:
                with record_function("bench/request"):
                    out = request(T, image)
                with record_function("bench/host_read"):
                    out["Ti_pred"].cpu()

        readings["traced"] = ctx["profile"](traced)
        readings["traced_frames"] = n * B
    del engine, model, base, prev, out, requests
    return dict(readings=readings, samples=res.items, scene=scene, weights=weights)


def judge(ctx, got, trace: bool):
    """(the serving numbers of `check.check_serving`, FLOPs per frame of
    the served forward or None): the FLOPs are FlopCounterMode's count over
    the reference's forward with cached 3D features at the cell's batch,
    taken in traced runs only."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, dev = ctx["config"], ctx["device"]
    flops = None
    if trace:
        mods = build.side("reference")
        check.exact_f32()
        model = build.build_model(mods, cfg, dev, f32=True).eval()
        build.load_weights(model, got["weights"])
        inputs = gen.as_inputs(mods, got["scene"])
        with torch.no_grad():
            d3, c3 = model.encode_3d(inputs.pyramid)
            with FlopCounterMode(display=False) as counter:
                model(inputs, cached_desc3d=d3, cached_ctx3d=c3)
        flops = counter.get_total_flops() / inputs.image.shape[0]
        del model
    numbers = check.check_serving(cfg, got["scene"], got["weights"], got["samples"], dev)
    return numbers, flops


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
