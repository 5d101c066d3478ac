"""The stamped stretch of a `stereo` cell's `--trace 1` run: what its stage
metrics read, by `stages.py`'s rules, as `stages_flow.py` reads RAFT's.

RAFT-Stereo's forward (`rnnpose_tpu_torch/models/raft_stereo.py`) stamps the
device clock between its stages inside the replayed graph: `encode` (pad,
normalise, both encoders, the context convolutions), `corr` (the 1D volume
and its pyramid), per iteration `lookup`, `coarse_gru` (gru32 and gru16 with
their pooling and interpolation) and `update` (motion encoder, gru08, flow
head, coordinates), and `upsample` (mask head, convex upsampling, unpad).
The first stage metric read for a cell runs the stretch in a process of its
own (`python -m benchmark.stages_stereo CONFIG TRAFFIC [SECONDS]`), from a
fixed seed: an untraced `FlowEngine` made ready gives the graph's node count
and its answer to one pair, and is freed; a traced one on the same model
answers the same pair (bits and node count printed beside the first's),
takes the warm-up requests as the window does, then runs at least STRETCH
calls, on past a slow start's drop (`stages.settle`) or until
STRETCH_SECONDS, each pair drawn and synchronised before its call and its
x-flow read back after it. The metrics read the calls after the drop;
nothing unless every stamp launched was expected and read back in order.

A program without RAFT-Stereo or without the tracer (an older checkout)
gives None, and every stage metric is left out of the line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from . import gen, gen_flow, serve, stages, stages_flow

__all__ = ["metric", "stretch", "readings", "STAGES"]

STAGES = ("encode", "corr", "lookup", "coarse_gru", "update", "upsample")

_DONE: Dict[str, Optional[Dict[str, float]]] = {}  # the stretch's readings, per cell


def _program_has_stereo() -> bool:
    try:
        from rnnpose_tpu_torch.models import engine, raft_stereo  # noqa: F401
        from rnnpose_tpu_torch.utils import profiling
    except ImportError:
        return False
    return hasattr(engine, "FlowEngine") and hasattr(profiling, "Tracer")


def metric(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """Stage metric `name` of a stereo cell's traced run on the card, or
    None (no traced run, no card, a program without RAFT-Stereo or the
    tracer, stamps that do not account)."""
    if (ctx["kind"] != "serve" or ctx.get("model") != "raft_stereo" or not ctx.get("traced")
            or not torch.cuda.is_available() or not _program_has_stereo()):
        return None
    key = json.dumps([ctx["config"], ctx["traffic"]], sort_keys=True)
    if key not in _DONE:
        out = subprocess.run([sys.executable, "-m", "benchmark.stages_stereo",
                              json.dumps(ctx["config"]), json.dumps(ctx["traffic"])],
                             cwd=stages.ROOT, stdout=subprocess.PIPE, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"the stamped stretch exited with {out.returncode}")
        _DONE[key] = json.loads(out.stdout.strip().splitlines()[-1])
    got = _DONE[key]
    return None if got is None else got.get(name)


def readings(doc, calls, batch: int, profiling) -> Optional[Dict[str, float]]:
    """`stages_flow.readings` of the export over `calls`, with every stage
    of STAGES (`coarse_gru` besides RAFT's): medians of the per-call stage
    device ms per frame."""
    out = stages_flow.readings(doc, calls, batch, profiling)
    if out is None:
        return None
    ms = profiling.stage_ms(doc, calls)
    out.update({f"{n}_ms_per_frame": statistics.median(ms.get(n, [0.0])) / batch
                for n in STAGES})
    return out


def stretch(cfg, traffic, dev, seconds: float = stages.STRETCH_SECONDS
            ) -> Optional[Dict[str, float]]:
    """Run the stamped stretch of a stereo cell: its readings, or None
    without RAFT-Stereo or the program's tracer."""
    if not _program_has_stereo():
        return None
    from rnnpose_tpu_torch.models.engine import FlowEngine
    from rnnpose_tpu_torch.utils import profiling

    from .runners.stereo import Pairs, build_program

    t0 = time.perf_counter()
    s = gen.seeds(stages.SEED)
    B, iters = traffic["batch"], cfg["iters"]
    model = build_program(cfg, dev)
    model.load_state_dict(gen_flow.make_weights(model, s["weights"], dev), strict=True)
    pairs = Pairs(cfg, traffic, s["requests"], dev)
    first = pairs.next()
    plain = FlowEngine(model)
    ref = plain.flow(*first, iters)
    nodes = sum(plain.graph_nodes.values())
    del plain
    stages._free(dev)

    tracer = profiling.Tracer(dev)
    engine = FlowEngine(model, tracer=tracer)
    out = engine.flow(*first, iters)
    equal = all(torch.equal(a, b) for a, b in zip(ref, out))
    del ref, out
    t_captured = time.perf_counter()
    warmups = 0
    while (warmups < traffic["warmup_requests"]
           or time.perf_counter() - t_captured < traffic.get("warmup_seconds", 0)):
        engine.flow(*pairs.next(), iters).flow.cpu()
        warmups += 1
    serve._sync(dev)
    start = tracer.calls + 1
    t_loop = time.perf_counter()
    lat: List[float] = []
    while not stages._enough(lat, time.perf_counter() - t_loop, seconds):
        i1, i2 = pairs.next()
        serve._sync(dev)
        t_req = time.perf_counter()
        engine.flow(i1, i2, iters).flow.cpu()
        lat.append((time.perf_counter() - t_req) * 1e3)
    doc = tracer.export()
    calls = list(range(start, tracer.calls + 1))
    marks = sum(st["replay"] for st in doc["stamps"] if st["call"] == start)
    stamped = sum(engine.graph_nodes.values())
    print(f"stamped stretch: graph nodes {nodes} untraced, {stamped} traced with {marks} marks "
          f"per replay ({'exactly' if stamped == nodes + marks else 'NOT'} the sum); one "
          f"pair's outputs bit-equal: {equal}", file=sys.stderr)
    del engine, model
    stages._free(dev)

    k, levels = stages._settled(doc, calls)
    got = readings(doc, calls[k:], B, profiling)
    if got is None:
        print(f"stamped stretch: the stamps do not account (launched "
              f"{doc['stamps_launched']}, expected {doc['stamps_expected']}, dropped "
              f"{doc['stamps_dropped']}, mismatched {doc['stamps_mismatched']}): no stage "
              f"metric", file=sys.stderr)
    extra = {"graph_nodes_per_frame": stages._per(nodes, B),
             "request_ms_p50": statistics.median(lat[k:])}
    result = dict(got or {}, **extra, slow_calls=k, slow_share=100.0 * k / len(calls))
    slow = (f"slow start: the first {k} of {len(calls)} calls, replay median {levels[0]:.4f} "
            f"ms, then {levels[1]:.4f} ms" if k else
            f"no drop seen in {len(calls)} calls (replay median {levels[1]:.4f} ms): one "
            f"level, settled or slow")
    print(f"stamped stretch ({time.perf_counter() - t0:.1f} s with set-up): {slow}; over the "
          f"last {len(calls) - k} calls: " + ", ".join(f"{key} {v!r}" for key, v in
                                                      result.items()), file=sys.stderr)
    print(profiling.report(doc, calls[k:]), file=sys.stderr)
    return result


if __name__ == "__main__":
    from .run import forbidden_modules

    got = stretch(json.loads(sys.argv[1]), json.loads(sys.argv[2]), stages._device(),
                  *(float(a) for a in sys.argv[3:4]))
    found = forbidden_modules()
    if found:
        print(f"stamped stretch: the process loaded {found}", file=sys.stderr)
        sys.exit(3)
    print(json.dumps(got))
