"""Inference engines: compiled forwards + per-class 3D feature caching (port
of `rnnpose_tpu/models/engine.py`), and the compiled flow of RAFT and
RAFT-Stereo.

`GraphEngine` is the graph-program core below; `InferenceEngine` serves
RNNPose on it (`refine`), and `FlowEngine` serves RAFT
(`models/raft_flow.RAFT`) and RAFT-Stereo (`models/raft_stereo.RAFTStereo`):
`flow(image1, image2, iters)`, one program per iteration count and key of
the frame pair, with the counters `flow_iters`, the iterations in each
program, and `corr_pyramid_bytes`, the correlation pyramid's bytes at its
capture, read from its levels. Both keep the core's keys, buffers,
warm-ups, capture, pool, replays, clones, counters and spans; the RAFT
forward's marks are `encode`, `corr`, `lookup`, `update` and `upsample`,
RAFT-Stereo's `coarse_gru` besides, between `lookup` and `update`.

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
`kernel_launches` (each `kernels` operator's kernel launches made while
capturing each graph, by operator and graph label, zeros included; one node
of the graph each: `lm_step` render x GRU x LM iterations an RNNPose
request, `corr_lookup` render x GRU iterations, or the iterations of a RAFT
pair, `corr_lookup_1d` the iterations of a RAFT-Stereo pair).

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
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..utils import profiling
from ..utils.profiling import END, span_on
from .kpconv_net import PointPyramid
from .raft_flow import FlowOutputs
from .rnnpose import RNNPose, RNNPoseInputs

__all__ = ["GraphEngine", "InferenceEngine", "FlowEngine", "WARMUP_RUNS"]

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
    """One key's compiled forward: the request buffers, the forward over
    them, the graph (None on the CPU), the outputs the graph writes (None
    on the CPU), the ids of the marks captured into the graph (a traced
    engine's) and the label its counters go by."""

    inputs: Any
    buffers: List[Optional[torch.Tensor]]
    forward: Callable[[Any], Any]
    graph: Any
    outputs: Any
    marks: List[int]
    label: str


class GraphEngine:
    """The graph-program core that `InferenceEngine` and `FlowEngine` share
    (see the module docstring): programs by key in one memory pool, the
    eager warm-ups, the capture, the replays and clones, the counters and
    the `engine/*` spans. A subclass keys its requests and gives each new
    key's forward over the static buffers (`_make`), and runs a program
    (`_run`) inside `_call`."""

    def __init__(self, model: torch.nn.Module, tracer: Optional[profiling.Tracer] = None):
        self.model = model
        self.tracer = tracer
        self._programs: Dict[tuple, _Program] = {}
        self._pool = None
        self.graph_captures = 0
        self.replays: Dict[str, int] = collections.Counter()
        self.graph_nodes: Dict[str, int] = {}
        self.kernel_launches: Dict[str, Dict[str, int]] = {op: {} for op in kernels.OPERATORS}
        if tracer is not None:
            tracer.attach("engine", self.counters)

    def counters(self) -> Dict[str, Any]:
        return {"graph_captures": self.graph_captures, "replays": dict(self.replays),
                "graph_nodes": dict(self.graph_nodes),
                "kernel_launches": {op: dict(by_label)
                                    for op, by_label in self.kernel_launches.items()}}

    def _call(self, name: str, fn):
        """fn(the tracer or None), inside one call `name` of the tracer."""
        if self.tracer is None:
            return fn(None)
        with self.tracer.call(name):
            return fn(self.tracer)

    def _make(self, key: tuple, request, leaves, label: str, forward) -> _Program:
        """The program of a new key: static buffers cloned from the request's
        leaves, and on the card `forward(static)` captured (the kernels'
        launches made by the capture are kept under `label`)."""
        buffers = [None if t is None else t.clone() for _, t in leaves]
        static = _unflatten(request, iter(buffers))
        device = next(self.model.parameters()).device
        graph = outputs = None
        marks: List[int] = []
        if device.type == "cuda":
            graph, outputs, marks, self.graph_nodes[label], launches = self._capture(
                device, static, forward)
            for op, n in launches.items():
                self.kernel_launches[op][label] = n
        self.graph_captures += 1
        self._programs[key] = _Program(static, buffers, forward, graph, outputs, marks, label)
        return self._programs[key]

    def _run(self, prog: _Program, leaves, tr):
        """Copy the request in, replay (the CPU: run the forward eagerly on
        the buffers) and return clones of the outputs."""
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
                outputs = self._forward(prog.forward, prog.inputs)
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

    @staticmethod
    def _forward(forward, static):
        out = forward(static)
        profiling.mark(END)  # closes the forward's last stage
        return out

    def _capture(self, device, static, forward):
        """Warm-ups on a side stream, then one forward captured in the
        engine's pool and instantiated; (graph, the outputs it writes, the
        marks captured, its node count, each operator's kernel launches in
        it)."""
        tr = self.tracer
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)
        with span_on(tr, "engine/warmup"), torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._forward(forward, static)
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = kernels.LAUNCHES.copy()
        with span_on(tr, "engine/capture"), torch.cuda.device(device), (
                tr.capture() if tr is not None else contextlib.nullcontext([])) as marks:
            # thread_local: another thread's work on the card (a loader's)
            # does not break the capture; this thread's host reads still
            # raise.
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = self._forward(forward, static)
            nodes = profiling.graph_nodes(graph)
            graph.instantiate()
        launches = {op: kernels.LAUNCHES[op] - before[op] for op in kernels.OPERATORS}
        return graph, outputs, marks, nodes, launches


class InferenceEngine(GraphEngine):
    """RNNPose's serving entry: the per-class `encode_3d` cache and one
    program per class and key (see the module docstring)."""

    def __init__(self, model: RNNPose, tracer: Optional[profiling.Tracer] = None):
        self._cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.encode_3d_calls = 0
        super().__init__(model, tracer)

    def counters(self) -> Dict[str, Any]:
        return dict(super().counters(), encode_3d_calls=self.encode_3d_calls)

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
        self._call("engine/prepare", lambda tr: self._program(class_name, inputs))

    def refine(self, class_name: str, inputs: RNNPoseInputs) -> Dict[str, Any]:
        """Refine one batch of poses of `class_name`: the model's eval
        outputs (Ti_pred etc.), fresh tensors that no later request
        overwrites."""
        return self._call("engine/refine", lambda tr: self._run(
            *self._program(class_name, inputs), tr))

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

        def forward(static):
            return self.model(static, train=False, cached_desc3d=desc3d, cached_ctx3d=ctx3d)

        label = f"{class_name}:{tuple(request.image.shape)}"
        return self._make(key, request, leaves, label, forward), leaves


class _FramePair(NamedTuple):
    """A flow request: two batches of frames (B, H, W, 3) in [0, 255]."""

    image1: torch.Tensor
    image2: torch.Tensor


class FlowEngine(GraphEngine):
    """The serving entry of RAFT (`models/raft_flow.RAFT`) and RAFT-Stereo
    (`models/raft_stereo.RAFTStereo`): one program per iteration count and
    key of the frame pair (see the module docstring). `flow(image1,
    image2)` returns the model's `FlowOutputs`, fresh tensors that no later
    request overwrites."""

    def __init__(self, model: torch.nn.Module, tracer: Optional[profiling.Tracer] = None):
        self.flow_iters: Dict[str, int] = {}
        self.corr_pyramid_bytes: Dict[str, int] = {}
        super().__init__(model, tracer)

    def counters(self) -> Dict[str, Any]:
        return dict(super().counters(), flow_iters=dict(self.flow_iters),
                    corr_pyramid_bytes=dict(self.corr_pyramid_bytes))

    def prepare(self, image1: torch.Tensor, image2: torch.Tensor, iters: int):
        """The program of this pair's key, made now if it is not yet."""
        self._call("engine/prepare", lambda tr: self._program(image1, image2, iters))

    def flow(self, image1: torch.Tensor, image2: torch.Tensor, iters: int) -> FlowOutputs:
        """The flow from image1 to image2 after `iters` iterations."""
        return self._call("engine/flow", lambda tr: self._run(
            *self._program(image1, image2, iters), tr))

    def _program(self, image1, image2, iters):
        if iters < 1:
            raise ValueError(f"iters must be at least 1, got {iters}")
        if image1.shape != image2.shape:
            raise ValueError(f"the frames differ in shape: {tuple(image1.shape)} and "
                             f"{tuple(image2.shape)}")
        request = _FramePair(image1, image2)
        leaves = _flatten(request, "", [])
        key = ("flow", iters) + _key(leaves)
        if key in self._programs:
            return self._programs[key], leaves
        label = f"flow:{tuple(image1.shape)}:{iters}"
        def forward(static):
            with torch.no_grad():
                out = self.model(static.image1, static.image2, iters)
            # Python runs at the warm-ups and the capture (the CPU: every run).
            self.corr_pyramid_bytes[label] = self.model.pyramid_nbytes
            return out

        self.flow_iters[label] = iters
        return self._make(key, request, leaves, label, forward), leaves
