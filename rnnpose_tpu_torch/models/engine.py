"""Inference engine: compiled forwards + per-class 3D feature caching (port
of `rnnpose_tpu/models/engine.py`).

The model stays free of per-class state; this object owns the caches. One
`RNNPose.encode_3d` per class name, then every batch of that class runs the
forward with the cached features. The feature cache is keyed by the class
name alone, as the JAX engine's is, and the cached features carry the batch
axis of the pyramid they were computed from: serve one batch size per class
name. `encode_3d_calls` counts the tower runs.

The JAX engine jits its forward: one program per class and shape. Here the
counterpart of that program is a CUDA graph. The first request of a key
(the class name and the shape, dtype and device of every tensor the cached
forward reads) copies its tensors into static buffers, runs the cached
forward eagerly `WARMUP_RUNS` times on a side stream (the kernels' libraries
load, the cuBLAS and cuDNN handles and workspaces are made), then captures
one forward into a `torch.cuda.CUDAGraph`; all of the engine's graphs share
one memory pool. Every request of the key copies its tensors into the
buffers, replays the graph on the current stream and returns clones of the
outputs (the next replay overwrites the graph's own). `graph_captures`
counts the programs made. The graph runs the eager forward's kernels in the
same order on the same stream, so a replay gives the eager forward's bits.

A program is fixed when it is made, as a jitted function is when it is
traced: the raster switches of `render/raster.py` and the backend flags
read then stay in it, and so do the addresses of the weights, so change the
weights in place (`load_state_dict`) and `evict` the classes whose features
they made. A capture or a replay that fails raises; nothing falls back to
the eager forward. A model on the CPU runs the same program with the eager
forward in place of the replay (the CPU has no graphs): the same keys,
buffers and clones.

Counters, always on: `encode_3d_calls`, `graph_captures`, `replays` (runs
of each program, by `"<class>:<image shape>"`), `graph_nodes` (each
captured graph's node count, `utils/profiling.graph_nodes`; graphs are made
with `keep_graph=True` and instantiated right after the count) and
`lm_launches` (the LM step kernel's launches made while capturing each
graph, `ops/raster_kernels.lm_step.launches`: one node of the graph each,
render x GRU x LM iterations a request).

Tracing: `InferenceEngine(model, tracer=utils.profiling.Tracer(device))`.
Each `refine` (and `prepare`) is then one call of the tracer, with the host
spans `engine/copy_in`, `engine/replay` and `engine/clone_out`, and
`engine/encode_3d`, `engine/warmup` and `engine/capture` when it makes a
program; the tracer is active around the eager work and the capture, so a
graph captured by a traced engine holds one stamp node per mark of the
forward (`encode`, `render`, `flow`, `pose`, `tail` and the closing `end`;
`utils/profiling`) beside exactly the nodes an untraced engine's graph
holds, and gives the same bits. `tracer.export()` holds it all, with the
engine's counters. Without a tracer each span site costs one `is None`
branch.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..ops import raster_kernels as rk
from ..utils import profiling
from ..utils.profiling import END, span_on
from .kpconv_net import PointPyramid
from .rnnpose import RNNPose, RNNPoseInputs

__all__ = ["InferenceEngine", "WARMUP_RUNS"]

WARMUP_RUNS = 2  # eager forwards of a key before its capture


_PYRAMID_FIELDS = ("points", "masks", "neighbors", "pools", "upsamples")


def _flatten(x, path: str, out: List[Tuple[str, Optional[torch.Tensor]]]):
    """The tensors (and the Nones) of nested NamedTuples and point
    pyramids, by field path (a pyramid's by field and level)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for name, v in zip(x._fields, x):
            _flatten(v, f"{path}.{name}" if path else name, out)
    elif isinstance(x, PointPyramid):
        for name in _PYRAMID_FIELDS:
            for level, t in enumerate(getattr(x, name)):
                _flatten(t, f"{path}.{name}.{level}", out)
    elif x is None or isinstance(x, torch.Tensor):
        out.append((path, x))
    else:
        raise TypeError(f"{path}: {type(x).__name__} is not a tensor, a point pyramid or a "
                        "NamedTuple of them")
    return out


def _unflatten(like, it):
    """`like` (nested NamedTuples and point pyramids) with its leaves taken
    from `it` in `_flatten`'s order."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, it) for v in like))
    if isinstance(like, PointPyramid):
        return PointPyramid(*([next(it) for _ in getattr(like, name)]
                              for name in _PYRAMID_FIELDS))
    return next(it)


def _key(leaves) -> tuple:
    """The path, shape, dtype and device of every leaf."""
    return tuple((path, None) if t is None else (path, tuple(t.shape), t.dtype, t.device)
                 for path, t in leaves)


def _check_batch(leaves, B: int, batched) -> None:
    """copy_ would broadcast a batch of one: every leaf `batched(path)`
    selects must carry the batch B."""
    for path, t in leaves:
        if t is not None and batched(path) and t.shape[0] != B:
            raise ValueError(f"{path} has batch {t.shape[0]}, the image {B}")


def _clone(x, memo: Dict[int, torch.Tensor]):
    """x with every tensor cloned (a tensor found twice cloned once), through
    dicts, lists, tuples and NamedTuples."""
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = x.clone()
        return memo[id(x)]
    if isinstance(x, dict):
        return {k: _clone(v, memo) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v, memo) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v, memo) for v in x)
    return x


class _Program(NamedTuple):
    """One key's compiled forward: the request buffers, the graph (None on
    the CPU), the outputs the graph writes (None on the CPU), the ids of
    the marks captured into the graph (a traced engine's) and the label
    its counters go by."""

    inputs: RNNPoseInputs
    buffers: List[Optional[torch.Tensor]]
    graph: Any
    outputs: Optional[Dict[str, Any]]
    marks: List[int]
    label: str


class InferenceEngine:
    def __init__(self, model: RNNPose, tracer: Optional[profiling.Tracer] = None):
        self.model = model
        self.tracer = tracer
        self._cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._programs: Dict[tuple, _Program] = {}
        self._pool = None
        self.encode_3d_calls = 0
        self.graph_captures = 0
        self.replays: Dict[str, int] = collections.Counter()
        self.graph_nodes: Dict[str, int] = {}
        self.lm_launches: Dict[str, int] = {}
        if tracer is not None:
            tracer.attach("engine", self.counters)

    def counters(self) -> Dict[str, Any]:
        return {"encode_3d_calls": self.encode_3d_calls, "graph_captures": self.graph_captures,
                "replays": dict(self.replays), "graph_nodes": dict(self.graph_nodes),
                "lm_launches": dict(self.lm_launches)}

    def class_features(self, class_name: str, pyramid: PointPyramid):
        """(desc3d, ctx3d) of a class, computed on first request."""
        if class_name not in self._cache:
            with span_on(self.tracer, "engine/encode_3d"):
                self._cache[class_name] = self.model.encode_3d(pyramid)
            self.encode_3d_calls += 1
        return self._cache[class_name]

    def prepare(self, class_name: str, inputs: RNNPoseInputs):
        """The class's features and the program of this request's key, made
        now if they are not yet (a request makes them otherwise): a caller
        that times its requests calls it before the clock starts."""
        if self.tracer is None:
            self._program(class_name, inputs)
            return
        with self.tracer.call("engine/prepare"):
            self._program(class_name, inputs)

    def refine(self, class_name: str, inputs: RNNPoseInputs) -> Dict[str, Any]:
        """Refine one batch of poses of `class_name`: the model's eval
        outputs (Ti_pred etc.), fresh tensors that no later request
        overwrites."""
        if self.tracer is None:
            return self._refine(class_name, inputs, None)
        with self.tracer.call("engine/refine"):
            return self._refine(class_name, inputs, self.tracer)

    def _refine(self, class_name: str, inputs: RNNPoseInputs, tr):
        prog, leaves = self._program(class_name, inputs)
        self.replays[prog.label] += 1
        with span_on(tr, "engine/copy_in"):
            profiling.mark("copy_in")
            # The key holds every shape, so no copy here broadcasts.
            for buf, (_, t) in zip(prog.buffers, leaves):
                if buf is not None:
                    buf.copy_(t)
            profiling.mark(END)
        with span_on(tr, "engine/replay"):
            if prog.graph is None:
                desc3d, ctx3d = self._cache[class_name]
                outputs = self._forward(prog.inputs, desc3d, ctx3d)
            else:
                prog.graph.replay()
                outputs = prog.outputs
                if tr is not None:
                    tr.replayed(prog.marks)
        with span_on(tr, "engine/clone_out"):
            profiling.mark("clone_out")
            out = _clone(outputs, {})
            profiling.mark(END)
        return out

    def evict(self, class_name: Optional[str] = None):
        """Drop one class's features and programs, or all of them."""
        if class_name is None:
            self._cache.clear()
            self._programs.clear()
            self._pool = None
        else:
            self._cache.pop(class_name, None)
            for key in [k for k in self._programs if k[0] == class_name]:
                del self._programs[key]

    def _forward(self, inputs, desc3d, ctx3d):
        out = self.model(inputs, train=False, cached_desc3d=desc3d, cached_ctx3d=ctx3d)
        profiling.mark(END)  # closes the forward's `tail`
        return out

    def _program(self, class_name: str, inputs: RNNPoseInputs):
        """(the program of the request's key, the request's leaves)."""
        # The cached forward reads neither the pyramid (once the class's
        # features are cached) nor the training correspondences.
        request = inputs._replace(pyramid=None, corr=None)
        leaves = _flatten(request, "", [])
        key = (class_name,) + _key(leaves)
        if key in self._programs:
            return self._programs[key], leaves
        desc3d, ctx3d = self.class_features(class_name, inputs.pyramid)
        # Every batched tensor must carry the image's batch (a class name
        # serves one batch size): the top-level ones and the features.
        _check_batch(leaves + [("cached_desc3d", desc3d), ("cached_ctx3d", ctx3d)],
                     request.image.shape[0], lambda path: "." not in path)
        buffers = [None if t is None else t.clone() for _, t in leaves]
        static = _unflatten(request, iter(buffers))
        device = next(self.model.parameters()).device
        label = f"{class_name}:{tuple(request.image.shape)}"
        graph = outputs = None
        marks: List[int] = []
        if device.type == "cuda":
            graph, outputs, marks, self.graph_nodes[label], self.lm_launches[label] = (
                self._capture(device, static, desc3d, ctx3d))
        self.graph_captures += 1
        prog = self._programs[key] = _Program(static, buffers, graph, outputs, marks, label)
        return prog, leaves

    def _capture(self, device, static, desc3d, ctx3d):
        """Warm-ups on a side stream, then one forward captured in the
        engine's pool and instantiated; (graph, the outputs it writes, the
        marks captured, its node count, the LM kernel's launches in it)."""
        tr = self.tracer
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)
        with span_on(tr, "engine/warmup"), torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._forward(static, desc3d, ctx3d)
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        lm_before = rk.lm_step.launches
        with span_on(tr, "engine/capture"), torch.cuda.device(device), (
                tr.capture() if tr is not None else contextlib.nullcontext([])) as marks:
            # thread_local: another thread's work on the card (a loader's)
            # does not break the capture; this thread's host reads still
            # raise.
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = self._forward(static, desc3d, ctx3d)
            nodes = profiling.graph_nodes(graph)
            graph.instantiate()
        return graph, outputs, marks, nodes, rk.lm_step.launches - lm_before
