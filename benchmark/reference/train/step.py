"""The training step, frozen from `rnnpose_tpu_torch/train/loop.py`'s eager
`make_train_step` without the process group and the profiler ranges:
forward -> loss -> backward -> the overflow-safe global norm of every
parameter's gradient (zeros where the loss does not reach) -> the update,
kept only where that norm is finite."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from .optim import DeviceAdam, safe_global_norm

__all__ = ["METRICS", "make_train_step"]

METRICS = ("loss", "circle_loss", "recall", "flow_loss", "loss_3d_proj")


def make_train_step(model, optimizer: DeviceAdam) -> Callable[..., Dict[str, torch.Tensor]]:
    params = list(model.parameters())

    def step(batch) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        out = model(batch, train=True)
        out["loss"].backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: out[k].detach().float() for k in METRICS}
        grad_norm = safe_global_norm([p.grad for p in params])
        finite = torch.isfinite(grad_norm)
        optimizer.step(finite)
        return dict(metrics, grad_norm=grad_norm.detach(), skipped_nonfinite=(~finite).float())

    return step
