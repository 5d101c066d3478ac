"""Training step and state (port of `rnnpose_tpu/train/loop.py`).

The step is forward -> loss -> backward -> grad_norm -> non-finite skip
guard -> update, in place on the model's parameters and the optimizer:
  * `grad_norm` is the overflow-safe global norm of every parameter's
    gradient, frozen ones included (a parameter the loss does not reach
    has a zero gradient, as under `jax.grad`);
  * the update is `train/optim.DeviceAdam` (for the model,
    `ScheduledAdam`: clip, Adam, weight decay, OneCycle), computed in full
    and then kept only where `grad_norm` is finite: every parameter, every
    moment and the update count is `torch.where(finite, new, old)`, and
    `skipped_nonfinite` is `(~finite).float()`, as the JAX package's jitted
    step selects (the reference has no guard). Nothing is read on the host;
  * under a process group (`parallel/mesh.py`) every gradient and the
    step's loss terms are averaged over the ranks in one flat all-reduce
    after the zero fill and before `grad_norm`: the losses are per-sample
    means, so the average is the global batch's gradient, the one JAX's
    SPMD step takes, and every rank reads the same norm and takes the same
    update. Without a process group no collective runs.
The three parts open the device stages `forward`, `backward` (with the
zero fill and the metric copies) and `update` (the norm, the guard and the
optimizer) of the tracer active on the thread (`utils/profiling.mark`;
the refiner's stages nest in `forward`), and do nothing without one.

The JAX package jits the step (`jax.jit(step, donate_argnums=(0, 1))`):
one program per batch shape. `Trainer`'s counterpart of that program is a
pair of CUDA graphs, made as `models/engine.InferenceEngine` makes its
forward's. The key is the path, shape, dtype and device of every tensor of
the batch (pyramid and correspondences included). The first
`WARMUP_RUNS` steps of a key are real steps: each copies its batch into
the key's static buffers and runs the eager step on them on a side stream
(the libraries load, the cuBLAS and cuDNN handles and workspaces are made,
the optimizer's state is touched). The next step captures the step into
two graphs in a memory pool the trainer owns, with
`capture_error_mode="thread_local"`: graph A sets the gradients to None
and runs the forward, the backward, the zero fill and the metric copies;
graph B the norm, the guard and the update. Capture records work and runs
none, so that step and every later one of the key copy the batch into the
buffers and replay A, then `all_reduce_mean_` eagerly (gloo goes through
host memory and cannot be captured; without a process group it does
nothing), then B, and return clones of B's metrics. The graphs run the
eager step's kernels in the same order on the same stream, so a replay
gives the eager step's bits. A capture that fails raises; nothing falls
back to the eager step. On the CPU the same program runs the eager step on
the buffers in place of the replays. `graph_captures` counts the programs
(on the CPU, made whole at their first step).

A program is fixed when it is made: it reads the parameters, the moments
and `count` at their addresses, and the raster switches and backend flags
of its capture stay in it. `load_state_dict` copies into those tensors, so
the programs stay valid. A program keeps its own gradient tensors, which
`p.grad` shows after each step.

Counters, always on: `graph_captures`, `replays` (replayed steps of each
program, by `"step:<image shape>"`; on the CPU every step of a program)
and `graph_nodes` (the node counts of its graphs A and B).

Tracing: `Trainer(model, cfg, tracer=utils.profiling.Tracer(device))`.
Each `run_step` is then one call of the tracer, with the host spans
`trainer/copy_in`, `trainer/warmup` or `trainer/capture` while the program
is made, then `trainer/replay_a`, `trainer/all_reduce`, `trainer/replay_b`
and `trainer/clone_out`; the tracer is active around the eager work and
the captures, so the graphs of a traced trainer hold one stamp node per
mark beside the nodes an untraced trainer's hold. `tracer.export()` holds
it all, with the trainer's counters.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..models.engine import WARMUP_RUNS, _check_batch, _flatten, _key, _unflatten
from ..models.rnnpose import RNNPose, RNNPoseInputs
from ..parallel.mesh import all_reduce_mean_
from ..utils import profiling
from ..utils.profiling import END, span_on
from .optim import DeviceAdam, OptimizerConfig, build_optimizer, safe_global_norm

__all__ = ["TrainState", "make_train_step", "Trainer", "WARMUP_RUNS"]

METRICS = ("loss", "circle_loss", "recall", "flow_loss", "loss_3d_proj")


@dataclasses.dataclass
class TrainState:
    model: RNNPose
    optimizer: DeviceAdam
    step: int = 0


def make_train_step(model: RNNPose, optimizer: DeviceAdam) -> Callable[
        [RNNPoseInputs], Dict[str, torch.Tensor]]:
    """The train step: batch -> metrics (detached 0-d tensors: loss,
    circle_loss, recall, flow_loss, loss_3d_proj, grad_norm,
    skipped_nonfinite), updating `model` and `optimizer` in place. Its two
    halves, which `Trainer` captures apart, are attributes of it:
    `forward_backward(batch) -> (grads, metrics)` and `update(grads,
    metrics) -> metrics`; the step is the first, the all-reduce, the
    second."""
    params = list(model.parameters())

    def forward_backward(batch: RNNPoseInputs):
        for p in params:
            p.grad = None
        profiling.mark("forward")
        out = model(batch, train=True)
        profiling.mark("backward")
        out["loss"].backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: out[k].detach().to(params[0].device, torch.float32, copy=True)
                   for k in METRICS}
        profiling.mark(END)
        return [p.grad for p in params], metrics

    def update(grads: List[torch.Tensor], metrics: Dict[str, torch.Tensor]):
        profiling.mark("update")
        grad_norm = safe_global_norm(grads)
        finite = torch.isfinite(grad_norm)
        optimizer.step(finite)
        out = dict(metrics, grad_norm=grad_norm.detach(), skipped_nonfinite=(~finite).float())
        profiling.mark(END)
        return out

    def step(batch: RNNPoseInputs) -> Dict[str, torch.Tensor]:
        grads, metrics = forward_backward(batch)
        # Across processes: the gradients and metrics of the global batch,
        # before the norm, so every rank skips or steps alike.
        all_reduce_mean_(grads + list(metrics.values()))
        return update(grads, metrics)

    step.forward_backward = forward_backward
    step.update = update
    return step


@dataclasses.dataclass(eq=False)
class _Program:
    """One batch key's compiled step: the batch buffers, the label its
    counters go by, the eager steps run so far, and once captured the two
    graphs with the gradients and metrics A writes, the metrics B writes
    and the ids of the marks captured into each (a traced trainer's)."""

    inputs: RNNPoseInputs
    buffers: List[Optional[torch.Tensor]]
    label: str
    runs: int = 0
    graphs: Optional[tuple] = None
    grads: Optional[List[torch.Tensor]] = None
    metrics_a: Optional[Dict[str, torch.Tensor]] = None
    metrics: Optional[Dict[str, torch.Tensor]] = None
    marks: tuple = ((), ())


class Trainer:
    """The device-side loop state: the model, its optimizer, the step
    count and the compiled steps (see the module docstring). Data, logging
    and checkpoint files are the CLI's (`tools/train.py`). The model is
    trained as it is given (random or loaded weights), on the device its
    parameters are on. `optimizer` replaces `build_optimizer(opt_cfg,
    model)`: a `DeviceAdam` over some of the model's parameters
    (`tools/overfit_check`'s clip + Adam)."""

    def __init__(self, model: RNNPose, opt_cfg: OptimizerConfig, optimizer=None,
                 tracer: Optional[profiling.Tracer] = None):
        optimizer = optimizer or build_optimizer(opt_cfg, model)
        if not isinstance(optimizer, DeviceAdam):
            raise TypeError(f"{type(optimizer).__name__} is not a DeviceAdam: the step's "
                            "guard and update run on the device")
        self.model = model
        self.tracer = tracer
        self.state = TrainState(model=model, optimizer=optimizer)
        self._step_fn = make_train_step(model, optimizer)
        self._params = list(model.parameters())
        self._programs: Dict[tuple, _Program] = {}
        self._pool = None
        self.graph_captures = 0
        self.replays: Dict[str, int] = collections.Counter()
        self.graph_nodes: Dict[str, List[int]] = {}
        if tracer is not None:
            tracer.attach("trainer", self.counters)

    def counters(self) -> Dict[str, Any]:
        return {"graph_captures": self.graph_captures, "replays": dict(self.replays),
                "graph_nodes": dict(self.graph_nodes)}

    def run_step(self, batch: RNNPoseInputs) -> Dict[str, torch.Tensor]:
        if self.tracer is None:
            metrics = self._step(batch, None)
        else:
            with self.tracer.call("trainer/step"):
                metrics = self._step(batch, self.tracer)
        self.state.step += 1
        return metrics

    def _step(self, batch: RNNPoseInputs, tr) -> Dict[str, torch.Tensor]:
        prog, leaves = self._program(batch)
        with span_on(tr, "trainer/copy_in"):
            profiling.mark("copy_in")
            # The key holds every shape, so no copy here broadcasts.
            for buf, (_, t) in zip(prog.buffers, leaves):
                if buf is not None:
                    buf.copy_(t)
            profiling.mark(END)
        return self._run(prog, tr)

    def _run(self, prog: _Program, tr) -> Dict[str, torch.Tensor]:
        device = self._params[0].device
        if device.type != "cuda":
            # The step's halves eagerly, in the replays' place.
            self.replays[prog.label] += 1
            with span_on(tr, "trainer/replay_a"):
                grads, metrics_a = self._step_fn.forward_backward(prog.inputs)
            with span_on(tr, "trainer/all_reduce"):
                all_reduce_mean_(grads + list(metrics_a.values()))
            with span_on(tr, "trainer/replay_b"):
                return self._step_fn.update(grads, metrics_a)
        if prog.runs < WARMUP_RUNS:
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device=device)
            side.wait_stream(current)
            with span_on(tr, "trainer/warmup"), torch.cuda.stream(side):
                metrics = self._step_fn(prog.inputs)
            current.wait_stream(side)
            prog.runs += 1
            return metrics
        if prog.graphs is None:
            with span_on(tr, "trainer/capture"):
                self._capture(prog, device, tr)
        for p, g in zip(self._params, prog.grads):
            if p.grad is not g:  # another key's step, or an eager one, set it
                p.grad = g
        self.replays[prog.label] += 1
        graph_a, graph_b = prog.graphs
        with span_on(tr, "trainer/replay_a"):
            graph_a.replay()
            if tr is not None:
                tr.replayed(prog.marks[0])
        with span_on(tr, "trainer/all_reduce"):
            all_reduce_mean_(prog.grads + list(prog.metrics_a.values()))
        with span_on(tr, "trainer/replay_b"):
            graph_b.replay()
            if tr is not None:
                tr.replayed(prog.marks[1])
        with span_on(tr, "trainer/clone_out"):
            profiling.mark("clone_out")
            out = {k: v.clone() for k, v in prog.metrics.items()}
            profiling.mark(END)
        return out

    def _capture(self, prog: _Program, device, tr):
        """Graph A (forward and backward) and graph B (the update) of the
        key, in the trainer's pool, counted and instantiated."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph_a = torch.cuda.CUDAGraph(keep_graph=True)
        graph_b = torch.cuda.CUDAGraph(keep_graph=True)

        def collect():
            return tr.capture() if tr is not None else contextlib.nullcontext([])

        # thread_local: another thread's work on the card (a loader's) does
        # not break the capture; this thread's host reads still raise.
        with torch.cuda.device(device):
            with collect() as marks_a, torch.cuda.graph(
                    graph_a, pool=self._pool, capture_error_mode="thread_local"):
                grads, metrics_a = self._step_fn.forward_backward(prog.inputs)
            with collect() as marks_b, torch.cuda.graph(
                    graph_b, pool=self._pool, capture_error_mode="thread_local"):
                metrics = self._step_fn.update(grads, metrics_a)
            self.graph_nodes[prog.label] = [profiling.graph_nodes(g) for g in (graph_a, graph_b)]
            graph_a.instantiate()
            graph_b.instantiate()
        prog.graphs, prog.grads, prog.metrics_a, prog.metrics = (
            (graph_a, graph_b), grads, metrics_a, metrics)
        prog.marks = (tuple(marks_a), tuple(marks_b))
        self.graph_captures += 1

    def _program(self, batch: RNNPoseInputs):
        """(the program of the batch's key, the batch's leaves)."""
        leaves = _flatten(batch, "", [])
        key = _key(leaves)
        if key in self._programs:
            return self._programs[key], leaves
        # Every batched tensor must carry the image's batch: the top-level
        # ones, the pyramid's and the correspondences' (the mesh is shared).
        _check_batch(leaves, batch.image.shape[0],
                     lambda path: not path.startswith("mesh."))
        buffers = [None if t is None else t.clone() for _, t in leaves]
        prog = self._programs[key] = _Program(_unflatten(batch, iter(buffers)), buffers,
                                              f"step:{tuple(batch.image.shape)}")
        if self._params[0].device.type != "cuda":
            self.graph_captures += 1
        return prog, leaves

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: {model, optimizer, step}."""
        return {"model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "step": self.state.step}

    def load_state_dict(self, state: Dict[str, Any], step: Optional[int] = None):
        """Copy a checkpoint into the tensors the programs read (the
        parameters, buffers, moments and update count, each in place)."""
        self.model.load_state_dict(state["model"])
        self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"] if step is None else step)
