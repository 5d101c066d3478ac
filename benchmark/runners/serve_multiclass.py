"""The `serve_multiclass` kind: B=1 tracking of several classes in turn
through one `InferenceEngine` (the program's per-class feature cache, one
graph key per class, and one graph pool whose graphs replay out of the
order they were captured in), under a closed loop of one client.

Set-up draws `classes` objects from the seed: each a padded icosphere of
the configuration's vertex and face budget with its own radius (uniform in
`radius_range`) and its vertices moved radially by a seeded `vertex_jitter`
share, in its own scene (`gen.make_scene` at the configuration's distance).
The shapes are the same, so only the classes' features and keys differ.
One model with the seed's weights serves them all; `prepare` makes each
class's features and program in order, then warm-up requests run: at
least `warmup_requests`, and on until `warmup_seconds` have passed since
the last capture (a capture puts every graph of the process into a slow
phase that ends 2 to 32 s later; PERF.md §6). The
window sends cycle after cycle: each cycle a seeded permutation of the
classes, each request one frame of that class drawn as in the `serve` kind
(`serve.Requests`: a seeded rigid jitter of the class's initial pose, plus
`chain` times that class's previous output, and fresh image noise) and
timed the same way, from the call to `refine` to the host read of its
pose. A seeded reservoir per class keeps `check_sample / classes` of its
requests, and the check is the `serve` kind's (`check.check_serving`),
class by class on each class's scene, the worst taken. The readings carry
kind `serve`, so the serving readers take them.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List
from unittest import mock

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import build, check, gen, serve

__all__ = ["run", "judge", "class_scene"]


def class_scene(cfg, radius: float, jitter: float, seed: int, device) -> gen.Scene:
    """One class's scene: `gen.make_scene` with the icosphere of `radius`
    whose vertices move radially by a seeded factor 1 + jitter * n (n a
    standard normal clipped to [-2, 2])."""
    rs = np.random.RandomState(seed % 2 ** 32)
    sphere = gen.icosphere

    def perturbed(subdivisions, r):
        m = sphere(subdivisions, r)
        f = 1.0 + jitter * np.clip(rs.randn(len(m.verts)), -2.0, 2.0)
        return dataclasses.replace(m, verts=(m.verts * f[:, None]).astype(np.float32))

    with mock.patch.object(gen, "icosphere", perturbed):
        return gen.make_scene(dict(cfg, object_scale=radius), 1, seed, device)


def _classes(cfg, traffic, seed: int, device):
    """[(name, scene)] of the traffic's classes, from `seed`."""
    rs = np.random.RandomState(seed % 2 ** 32)
    lo, hi = traffic["radius_range"]
    out = []
    for c in range(traffic["classes"]):
        radius = float(rs.uniform(lo, hi))
        out.append((f"class{c}", class_scene(cfg, radius, traffic["vertex_jitter"],
                                             int(rs.randint(2 ** 31)), device)))
    return out


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    """Set-up, window and (with ctx["trace"]) a traced stretch; the
    readings, and each class's reservoir for the check."""
    from rnnpose_tpu_torch.models.engine import InferenceEngine

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    if traffic["batch"] != 1:
        raise ValueError("the multiclass traffic tracks one frame per request")
    s = gen.seeds(ctx["seed"])
    mods = build.side("program")
    classes = _classes(cfg, traffic, s["scene"], dev)
    serve._reset_peak(dev)  # the scenes' renders are the benchmark's, not the program's
    model = build.build_model(mods, cfg, dev).eval()
    weights = gen.make_weights(model, s["weights"], dev)
    build.load_weights(model, weights)
    engine = InferenceEngine(model)
    n = len(classes)
    bases = [gen.as_inputs(mods, scene) for _, scene in classes]
    streams = [serve.Requests(traffic, scene, s["requests"] + c)
               for c, (_, scene) in enumerate(classes)]
    order_rng = np.random.default_rng(s["requests"] % 2 ** 63)
    refine = engine.refine
    prev: List[Any] = [None] * n

    def request(c, T, image):
        return refine(classes[c][0], bases[c]._replace(T_init=T, image=image))

    def cycle():
        return [int(c) for c in order_rng.permutation(n)]

    t_built = time.perf_counter()
    for (name, _), base in zip(classes, bases):
        engine.prepare(name, base)
    serve._sync(dev)
    t_prepared = time.perf_counter()
    order: List[int] = []
    warmups = 0
    while (warmups < traffic["warmup_requests"]
           or time.perf_counter() - t_prepared < traffic["warmup_seconds"]):
        order = order or cycle()
        c = order.pop(0)
        prev[c] = request(c, *streams[c].next(prev[c]))["Ti_pred"]
        warmups += 1
    serve._sync(dev)
    captures = engine.graph_captures
    setup_s = time.perf_counter() - ctx["t_start"]
    print(f"setup: {t_built - ctx['t_start']:.3f} s to the built model and scenes, prepare "
          f"of {n} classes (encode_3d, warm-ups, capture) {t_prepared - t_built:.3f} s, "
          f"{warmups} warm-up requests {setup_s - (t_prepared - ctx['t_start']):.3f} s",
          file=sys.stderr)

    per_class = max(1, traffic["check_sample"] // n)
    res = [serve._Reservoir(per_class, s["check"] + c) for c in range(n)]
    lat_ms: List[float] = []
    host_ms: List[float] = []
    failed = 0
    spans = serve.Spans(dev)
    t0 = time.perf_counter()
    spans.open()
    while time.perf_counter() - t0 < ctx["seconds"]:
        order = order or cycle()
        c = order.pop(0)
        T, image = streams[c].next(prev[c])
        serve._sync(dev)
        t_req = time.perf_counter()
        spans.begin()
        out = request(c, T, image)
        spans.end()
        t_ret = time.perf_counter()
        pose = out["Ti_pred"].cpu()
        t_done = time.perf_counter()
        lat_ms.append((t_done - t_req) * 1e3)
        host_ms.append((t_ret - t_req) * 1e3)
        failed += int(not bool(torch.isfinite(pose).all()))
        prev[c] = out["Ti_pred"]
        res[c].offer(lambda: dict(T_init=T, image=image, Ti_pred=out["Ti_pred"],
                                  Ti_history=out["refiner"].Ti_history,
                                  Tij_history=out["refiner"].Tij_history,
                                  flow_history=out["refiner"].flow_history))
    spans.close()
    serve._sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    q = np.quantile(lat_ms, [0.05, 0.5, 0.95]) if lat_ms else [float("nan")] * 3
    print(f"window: {len(lat_ms)} requests over {n} classes in {window_s:.3f} s; request ms "
          f"p5 {q[0]:.3f} p50 {q[1]:.3f} p95 {q[2]:.3f} max {max(lat_ms):.3f}; host ms per "
          f"call mean {sum(host_ms) / len(host_ms):.3f}; programs {engine.graph_captures}; mean "
          f"request ms by tenth of the window "
          f"{[round(float(np.mean(c)), 2) for c in np.array_split(lat_ms, 10) if len(c)]}",
          file=sys.stderr)

    readings = dict(kind="serve", setup_s=setup_s, window_s=window_s, requests=len(lat_ms),
                    frames=len(lat_ms), latencies_ms=lat_ms, host_ms=host_ms,
                    failed=failed, memory_peak_bytes=peak,
                    new_captures=engine.graph_captures - captures,
                    encode_3d_calls=engine.encode_3d_calls, batch=1, call_gaps=spans.gaps())
    if ctx["trace"]:
        # Drawn before the profiler starts, with no chain, cycling through
        # the classes in the traffic's order.
        drawn = []
        for _ in range(traffic["trace_requests"]):
            order = order or cycle()
            c = order.pop(0)
            drawn.append((c, *streams[c].next()))
        serve._sync(dev)

        def traced():
            for c, T, image in drawn:
                with record_function("bench/request"):
                    out = request(c, T, image)
                with record_function("bench/host_read"):
                    out["Ti_pred"].cpu()

        readings["traced"] = ctx["profile"](traced)
        readings["traced_frames"] = len(drawn)
    del engine, model, bases, prev, out, streams
    return dict(readings=readings, samples=[r.items for r in res],
                scenes=[scene for _, scene in classes], weights=weights)


def judge(ctx, got, trace: bool):
    """(the worst of each class's serving numbers, FLOPs per frame or
    None): `check.check_serving` on each class's scene and sample, and the
    `serve` kind's FLOP count on the first class's scene."""
    from benchmark.serve import judge as serve_judge

    cfg, dev = ctx["config"], ctx["device"]
    numbers, flops = serve_judge(ctx, dict(got, scene=got["scenes"][0],
                                           samples=got["samples"][0]), trace)
    worst = {k: v for k, v in numbers.items() if isinstance(v, (int, float))}
    for scene, samples in zip(got["scenes"][1:], got["samples"][1:]):
        more = check.check_serving(cfg, scene, got["weights"], samples, dev)
        for k, v in more.items():
            if k == "compared":
                worst[k] += v
            elif isinstance(v, (int, float)):
                worst[k] = max(worst[k], v)
    return worst, flops
