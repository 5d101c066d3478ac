"""The stamped stretch of a `--trace 1` run: what the stage metrics read.

The program's tracer (`rnnpose_tpu_torch/utils/profiling.Tracer`) stamps
the device clock between the forward's stages inside the replayed CUDA
graph, and keeps host spans at the engine's and trainer's boundaries. A
stage metric's reader calls `metric(ctx, kind, name)`; the first such call
for a cell builds the program anew on the cell's configuration and runs
the stretch, and this module keeps its numbers for the cell's other
readers. The window and the profiled stretch before it ran untouched,
with tracing off. The stretch runs in a process of its own (`python -m
benchmark.stages CONFIG TRAFFIC [SECONDS]`, the first two as JSON; its
last stdout line is the readings; it exits non-zero if it loaded JAX or
the JAX package): a process that has run `torch.profiler` over the card
keeps paying for it in every graph launch afterwards.

The stretch, from a fixed seed (it measures time, not answers): an
untraced engine or trainer made ready (`prepare`, or the warm-up steps and
the capture) gives the graph's node count, and in serving its answer to
one request; it is freed. A second one on the same model, with a
`Tracer`, is made ready, answers the same request (its bits and node
count are printed beside the first's), takes the traffic's warm-up
requests, then runs without the profiler. A serving request is drawn and
synchronised before its call and its pose read back after it, as in the
window; training steps queue with no host read, as in the window, but for
a synchronise every CHECK steps.

A fresh graph starts slow, then speeds up once, at a random moment (PERF.md
section 6). The stretch runs at least STRETCH calls, and on until STRETCH
calls have followed a drop that `settle` finds in the calls' host times,
or until `seconds` (STRETCH_SECONDS) have passed. The metrics read the
calls after the drop that `settle` finds in the replays' stamped device
times, or every call where it finds none; stderr gives the calls before
the drop (`slow_calls`, `slow_share`) and the two levels. `readings`
gives nothing unless every stamp launched was expected and read back in
order. The tracer's report goes to stderr.

A program without the tracer (an older checkout) gives None, and every
stage metric is left out of the line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from . import build, gen, serve

__all__ = ["metric", "stretch", "readings", "settle", "STRETCH", "STRETCH_SECONDS"]

STRETCH = 100            # stamped requests or steps, after the drop where one is seen
STRETCH_SECONDS = 30.0   # at most, by the host's clock, unless fewer than STRETCH calls ran
CHECK = 10               # calls between two looks for the drop
DROP = 0.015             # the slow level over the settled one, at least (parity: +2.3%)
SLOW_MIN, SETTLED_MIN = 5, 20  # calls on each side of a drop, at least
SEED = 2 ** 31 + 19
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DONE: Dict[str, Optional[Dict[str, float]]] = {}  # the stretch's readings, per cell


def metric(ctx: Dict[str, Any], kind: str, name: str) -> Optional[float]:
    """Stage metric `name` of a `kind` cell's traced run on the card, or
    None (another kind, no traced run, no card, a program without the
    tracer, stamps that do not account)."""
    if ctx["kind"] != kind or not ctx.get("traced") or not torch.cuda.is_available():
        return None
    key = json.dumps([ctx["config"], ctx["traffic"]], sort_keys=True)
    if key not in _DONE:
        _DONE[key] = _in_child(ctx["config"], ctx["traffic"])
    got = _DONE[key]
    return None if got is None else got.get(name)


def _in_child(cfg, traffic) -> Optional[Dict[str, float]]:
    """`stretch` in a fresh process on the card (its report on stderr)."""
    from rnnpose_tpu_torch.utils import profiling

    if not hasattr(profiling, "Tracer"):
        return None
    out = subprocess.run([sys.executable, "-m", "benchmark.stages", json.dumps(cfg),
                          json.dumps(traffic)], cwd=ROOT, stdout=subprocess.PIPE, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"the stamped stretch exited with {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def settle(times: Sequence[float]) -> Optional[int]:
    """The index of the first call after a slow start in per-call times, or
    None: the split that leaves the least squared error about the two
    sides' means, taken where it has at least SLOW_MIN calls before it and
    SETTLED_MIN after, and the median before it is at least (1 + DROP)
    times the median after it."""
    n = len(times)
    if n < SLOW_MIN + SETTLED_MIN:
        return None
    mid = statistics.median(times)  # centred, so that the squares keep their digits
    s, q = [0.0], [0.0]
    for x in (t - mid for t in times):
        s.append(s[-1] + x)
        q.append(q[-1] + x * x)

    def sse(a, b):
        return q[b] - q[a] - (s[b] - s[a]) ** 2 / (b - a)

    k = min(range(1, n), key=lambda k: sse(0, k) + sse(k, n))
    if not SLOW_MIN <= k <= n - SETTLED_MIN:
        return None
    slow, settled = statistics.median(times[:k]), statistics.median(times[k:])
    return k if slow >= (1 + DROP) * settled else None


def _enough(times: List[float], elapsed: float, seconds: float) -> bool:
    """Whether the stretch may stop (see the module docstring)."""
    n = len(times)
    if n and elapsed >= seconds:
        return True
    if n < STRETCH or n % CHECK:
        return False
    k = settle(times)
    return k is not None and n - k >= STRETCH


def _device() -> torch.device:
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def _free(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def stretch(cfg, traffic, dev, seconds: float = STRETCH_SECONDS
            ) -> Optional[Dict[str, float]]:
    """Run the stamped stretch of a `serve` or `train` cell (see the module
    docstring): its readings, or None without the program's tracer."""
    from rnnpose_tpu_torch.utils import profiling

    if not hasattr(profiling, "Tracer"):
        return None
    t0 = time.perf_counter()
    run = _serve if traffic["kind"] == "serve" else _train
    doc, calls, extra = run(cfg, traffic, dev, profiling, seconds)
    k, levels = _settled(doc, calls)
    got = readings(doc, calls[k:], traffic["kind"], traffic["batch"], profiling)
    if got is None:
        print(f"stamped stretch: the stamps do not account (launched "
              f"{doc['stamps_launched']}, expected {doc['stamps_expected']}, dropped "
              f"{doc['stamps_dropped']}, mismatched {doc['stamps_mismatched']}): no stage "
              f"metric", file=sys.stderr)
    lat = extra.pop("request_ms", None)
    if lat:
        extra["request_ms_p50"] = statistics.median(lat[k:])
    out = dict(got or {}, **extra, slow_calls=k, slow_share=100.0 * k / len(calls))
    slow = (f"slow start: the first {k} of {len(calls)} calls, replay median {levels[0]:.4f} "
            f"ms, then {levels[1]:.4f} ms" if k else
            f"no drop seen in {len(calls)} calls (replay median {levels[1]:.4f} ms): one "
            f"level, settled or slow")
    print(f"stamped stretch ({time.perf_counter() - t0:.1f} s with set-up): {slow}; over the "
          f"last {len(calls) - k} calls: " + ", ".join(f"{key} {v!r}" for key, v in out.items()),
          file=sys.stderr)
    print(profiling.report(doc, calls[k:]), file=sys.stderr)
    return out


def _settled(doc, calls):
    """(calls before the drop that `settle` finds in the calls' stamped
    device times, 0 where it finds none; the median ms before and after)."""
    by_id = {c["id"]: c for c in doc["calls"]}
    ms = []
    for i in calls:
        c = by_id[i]
        ns = c["replay_ns"] if c["replay_ns"] is not None else (
            c["last_stamp_ns"] - c["first_stamp_ns"])  # the CPU: no graph
        ms.append(ns / 1e6)
    k = settle(ms) or 0
    return k, (statistics.median(ms[:k]) if k else None, statistics.median(ms[k:]))


def readings(doc, calls, kind: str, batch: int, profiling) -> Optional[Dict[str, float]]:
    """The stage metrics of an export over its calls `calls`: medians of
    the per-call stage device ms per frame or sample, the share of the
    stretch in which the device waited on the host inside a call, and the
    mean host ms of the replays' spans per call. None unless every stamp
    launched was expected, kept and of the expected mark: one stray stamp
    would shift every interval after it."""
    if (doc["stamps_mismatched"] or doc["stamps_dropped"]
            or doc["stamps_launched"] != doc["stamps_expected"]):
        return None
    sel = [c for c in doc["calls"] if c["id"] in set(calls)]
    lo = min(c["start_ns"] for c in sel)
    hi = max(max(c["end_ns"], c["last_stamp_ns"] or 0) for c in sel)
    idle = sum(i["ns"] for i in doc["idle"] if i["call"] in set(calls))
    out: Dict[str, float] = {}
    if kind == "serve":
        stages = profiling.stage_ms(doc, calls)
        for name in ("encode", "render", "flow", "pose", "tail"):
            out[f"{name}_ms_per_frame"] = statistics.median(stages.get(name, [0.0])) / batch
        replay = profiling.span_ms(doc, "engine/replay", calls)
        out["engine_replay_host_ms"] = sum(replay) / len(replay)
        unit = "frame"
    else:
        groups = profiling.group_ms(doc, ("forward", "backward", "update"), calls)
        for name, v in groups.items():
            out[f"{name}_ms_per_sample"] = statistics.median(v) / batch
        a = profiling.span_ms(doc, "trainer/replay_a", calls)
        b = profiling.span_ms(doc, "trainer/replay_b", calls)
        out["trainer_replay_host_ms"] = (sum(a) + sum(b)) / len(a)
        unit = "sample"
    replays = [c["replay_ns"] / 1e6 for c in sel if c["replay_ns"] is not None]
    out[f"replay_ms_per_{unit}"] = statistics.median(replays) / batch if replays else None
    out["device_idle_in_call_share"] = 100.0 * idle / (hi - lo)
    out["clock_error_us"] = doc["clock"]["error_ns"] / 1e3
    return out


def _serve(cfg, traffic, dev, profiling, seconds):
    from rnnpose_tpu_torch.models.engine import InferenceEngine

    s = gen.seeds(SEED)
    B = traffic["batch"]
    mods = build.side("program")
    scene = gen.make_scene(cfg, B, s["scene"], dev)
    model = build.build_model(mods, cfg, dev).eval()
    build.load_weights(model, gen.make_weights(model, s["weights"], dev))
    base = gen.as_inputs(mods, scene)
    cls = cfg["name"]
    requests = serve.Requests(traffic, scene, s["requests"])
    plain = InferenceEngine(model)
    plain.prepare(cls, base)
    ref = plain.refine(cls, base)
    nodes = sum(plain.graph_nodes.values())
    del plain
    _free(dev)

    tracer = profiling.Tracer(dev)
    engine = InferenceEngine(model, tracer=tracer)
    engine.prepare(cls, base)
    out = engine.refine(cls, base)
    equal = all(torch.equal(a, b) for a, b in zip(_leaves(ref), _leaves(out)))
    prev = None
    for _ in range(traffic["warmup_requests"]):
        T, image = requests.next(prev)
        prev = engine.refine(cls, base._replace(T_init=T, image=image))["Ti_pred"]
    serve._sync(dev)
    start = tracer.calls + 1
    t0 = time.perf_counter()
    lat: List[float] = []
    while not _enough(lat, time.perf_counter() - t0, seconds):
        T, image = requests.next(prev)
        serve._sync(dev)
        t_req = time.perf_counter()
        prev = engine.refine(cls, base._replace(T_init=T, image=image))["Ti_pred"]
        prev.cpu()
        lat.append((time.perf_counter() - t_req) * 1e3)
    doc = tracer.export()
    marks = sum(s["replay"] for s in doc["stamps"] if s["call"] == start)
    stamped = sum(engine.graph_nodes.values())
    print(f"stamped stretch: graph nodes {nodes} untraced, {stamped} traced with {marks} marks "
          f"per replay ({'exactly' if stamped == nodes + marks else 'NOT'} the sum); one "
          f"request's outputs bit-equal: {equal}", file=sys.stderr)
    del engine, model
    _free(dev)
    return doc, list(range(start, tracer.calls + 1)), {
        "graph_nodes_per_frame": _per(nodes, B), "request_ms": lat}


def _train(cfg, traffic, dev, profiling, seconds):
    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS, Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    from . import train

    s = gen.seeds(SEED)
    B = traffic["batch"]
    mods = build.side("program")
    scene = gen.make_scene(cfg, B, s["scene"], dev)
    model = build.build_model(mods, cfg, dev)
    weights = gen.make_weights(model, s["weights"], dev)
    pool = train.make_pool(traffic, scene, s["requests"] % (2 ** 31))
    batches = [gen.as_inputs(mods, scene, b["image"], b["T_init"], b["corr"]) for b in pool]

    build.load_weights(model, weights)
    plain = Trainer(model, OptimizerConfig())
    for k in range(WARMUP_RUNS + 1):
        plain.run_step(batches[k % len(batches)])
    nodes = sum(sum(v) for v in plain.graph_nodes.values())
    del plain
    _free(dev)

    build.load_weights(model, weights)
    tracer = profiling.Tracer(dev)
    trainer = Trainer(model, OptimizerConfig(), tracer=tracer)
    for k in range(WARMUP_RUNS + 1):
        trainer.run_step(batches[k % len(batches)])
    serve._sync(dev)
    start = tracer.calls + 1
    t0 = time.perf_counter()
    step_ms: List[float] = []  # each chunk's mean, once per step
    while not _enough(step_ms, time.perf_counter() - t0, seconds):
        t_chunk = time.perf_counter()
        for _ in range(CHECK):
            trainer.run_step(batches[len(step_ms) % len(batches)])
            step_ms.append(0.0)
        serve._sync(dev)
        step_ms[-CHECK:] = [(time.perf_counter() - t_chunk) * 1e3 / CHECK] * CHECK
    doc = tracer.export()
    marks = sum(s["replay"] for s in doc["stamps"] if s["call"] == start)
    stamped = sum(sum(v) for v in trainer.graph_nodes.values())
    print(f"stamped stretch: graph nodes {nodes} untraced (A + B), {stamped} traced with "
          f"{marks} marks per step ({'exactly' if stamped == nodes + marks else 'NOT'} the sum)",
          file=sys.stderr)
    del trainer, model
    _free(dev)
    return doc, list(range(start, tracer.calls + 1)), {"graph_nodes_per_sample": _per(nodes, B)}


def _per(nodes: int, batch: int) -> Optional[float]:
    """Graph nodes per frame or sample; None where no graph was captured
    (the CPU)."""
    return nodes / batch if nodes else None


def _leaves(x):
    """The tensors of nested dicts, lists, tuples and NamedTuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


if __name__ == "__main__":
    from .run import forbidden_modules

    got = stretch(json.loads(sys.argv[1]), json.loads(sys.argv[2]), _device(),
                  *(float(a) for a in sys.argv[3:4]))
    found = forbidden_modules()
    if found:
        print(f"stamped stretch: the process loaded {found}", file=sys.stderr)
        sys.exit(3)
    print(json.dumps(got))
