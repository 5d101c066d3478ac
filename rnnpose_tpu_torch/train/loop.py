"""Training step and state (port of `rnnpose_tpu/train/loop.py`).

The step is forward -> loss -> backward -> grad_norm -> non-finite skip
guard -> update, in place on the model's parameters and the optimizer:
  * `grad_norm` is the overflow-safe global norm of every parameter's
    gradient, frozen ones included (a parameter the loss does not reach
    has a zero gradient, as under `jax.grad`);
  * a step whose `grad_norm` is not finite changes neither the parameters
    nor the optimizer state and reports `skipped_nonfinite = 1` (the JAX
    package's guard; the reference has none);
  * the update is `train/optim.ScheduledAdam` (clip, Adam, weight decay,
    OneCycle);
  * under a process group (`parallel/mesh.py`) every gradient and the
    step's loss terms are averaged over the ranks in one flat all-reduce
    after the zero fill and before `grad_norm`: the losses are per-sample
    means, so the average is the global batch's gradient, the one JAX's
    SPMD step takes, and every rank reads the same norm and takes the same
    update. Without a process group no collective runs.
The guard reads `grad_norm` on the host: one device sync per step. The
three parts run in `torch.profiler` ranges, `train_step/forward`,
`train_step/backward` and `train_step/update` (the norm, the guard and the
optimizer), which a profile of the step reads its host split from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from ..models.rnnpose import RNNPose, RNNPoseInputs
from ..parallel.mesh import all_reduce_mean_
from .optim import OptimizerConfig, ScheduledAdam, build_optimizer, safe_global_norm

__all__ = ["TrainState", "make_train_step", "Trainer"]

METRICS = ("loss", "circle_loss", "recall", "flow_loss", "loss_3d_proj")


@dataclasses.dataclass
class TrainState:
    model: RNNPose
    optimizer: ScheduledAdam
    step: int = 0


def make_train_step(model: RNNPose, optimizer: ScheduledAdam) -> Callable[
        [RNNPoseInputs], Dict[str, torch.Tensor]]:
    """The train step: batch -> metrics (detached 0-d tensors: loss,
    circle_loss, recall, flow_loss, loss_3d_proj, grad_norm,
    skipped_nonfinite), updating `model` and `optimizer` in place."""
    params = list(model.parameters())

    def step(batch: RNNPoseInputs) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        with record_function("train_step/forward"):
            out = model(batch, train=True)
        with record_function("train_step/backward"):
            out["loss"].backward()
        with record_function("train_step/update"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            metrics = {k: out[k].detach().to(params[0].device, torch.float32, copy=True)
                       for k in METRICS}
            # Across processes: the gradients and metrics of the global
            # batch, before the norm, so every rank skips or steps alike.
            all_reduce_mean_([p.grad for p in params] + list(metrics.values()))
            grad_norm = safe_global_norm(p.grad for p in params)
            finite = bool(torch.isfinite(grad_norm))
            if finite:
                optimizer.step()
        metrics["grad_norm"] = grad_norm.detach()
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if finite else 1.0)
        return metrics

    return step


class Trainer:
    """The device-side loop state: the model, its optimizer and the step
    count. Data, logging and checkpoint files are the CLI's
    (`tools/train.py`). The model is trained as it is given (random or
    loaded weights), on the device its parameters are on."""

    def __init__(self, model: RNNPose, opt_cfg: OptimizerConfig):
        self.model = model
        self.state = TrainState(model=model, optimizer=build_optimizer(opt_cfg, model))
        self._step_fn = make_train_step(model, self.state.optimizer)

    def run_step(self, batch: RNNPoseInputs) -> Dict[str, torch.Tensor]:
        metrics = self._step_fn(batch)
        self.state.step += 1
        return metrics

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: {model, optimizer, step}."""
        return {"model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "step": self.state.step}

    def load_state_dict(self, state: Dict[str, Any], step: Optional[int] = None):
        self.model.load_state_dict(state["model"])
        self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"] if step is None else step)
