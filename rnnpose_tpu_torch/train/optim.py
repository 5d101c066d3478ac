"""Optimizer and learning-rate schedules (port of
`rnnpose_tpu/train/optim.py`).

The JAX package's optax chain, update for update:
  1. clip the trainable gradients to `grad_clip` by their overflow-safe
     global norm;
  2. Adam with beta1 = the OneCycle momentum at the update count, beta2 =
     0.99, eps 1e-8 and bias correction 1 - beta1^(count+1) with the
     current beta1;
  3. decoupled weight decay added to the Adam direction;
  4. scaling by -lr(count), the OneCycle rate.
Steps 2-4 are `torch.optim.AdamW` with `lr` and `betas` set from the
schedules before each step (its `p *= 1 - lr * wd` is the decayed-weights
term of step 3). `count` is the number of applied updates, as the optax
state counts them: a step the train loop skips does not advance it.

Freezing: `freeze_patterns` are regexes over the JAX package's flax
parameter paths (`params/hybrid/desc2d/...`, see
`models/convert.flax_paths`), so one pattern freezes the same tensors in
both packages. Frozen parameters keep their gradients (the train loop's
`grad_norm` counts them) but are not in the optimizer. KPConv kernel points
are buffers here, never parameters. `amsgrad` is accepted and ignored, as
in the JAX chain.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn

from ..models.convert import flax_paths

__all__ = [
    "OptimizerConfig",
    "one_cycle_schedule",
    "one_cycle_momentum_schedule",
    "exponential_decay_schedule",
    "manual_stepping_schedule",
    "safe_global_norm",
    "safe_clip_by_global_norm",
    "trainable_mask",
    "freeze_mask",
    "ScheduledAdam",
    "build_optimizer",
]


def safe_global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Overflow-safe L2 norm of a set of tensors: prescaled by the largest
    |element| when that exceeds 1e4 (exactly 1 for healthy magnitudes), so
    huge-but-finite gradients give a finite norm. A non-finite element
    still gives a non-finite norm."""
    leaves = [t.float() for t in tensors if t.numel()]
    if not leaves:
        return torch.zeros(())
    gmax = torch.stack([t.abs().amax() for t in leaves]).amax()
    scale = torch.where(gmax > 1e4, gmax, torch.ones_like(gmax))
    ss = sum(torch.sum(torch.square(t / scale)) for t in leaves)
    return scale * torch.sqrt(ss)


def safe_clip_by_global_norm(tensors: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `tensors` in place so their safe global norm is at most
    `max_norm`; returns that norm (before clipping)."""
    norm = safe_global_norm(tensors)
    factor = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    if tensors:
        torch._foreach_mul_(tensors, factor.to(tensors[0].device))
    return norm


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Mirrors `template_fw0.5.yml:112-131`."""

    lr_max: float = 1e-4
    moms: Tuple[float, float] = (0.95, 0.85)
    div_factor: float = 10.0
    pct_start: float = 0.01
    weight_decay: float = 1e-4
    amsgrad: bool = False          # accepted, ignored (as in the JAX chain)
    total_steps: int = 200_000
    grad_clip: float = 10.0
    freeze_patterns: Tuple[str, ...] = ()


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


def _one_cycle(cfg: OptimizerConfig, first: float, peak: float, last: float):
    a1 = int(cfg.total_steps * cfg.pct_start)

    def sched(step: int) -> float:
        if step < a1:
            return _annealing_cos(first, peak, step / max(a1, 1))
        return _annealing_cos(peak, last, (step - a1) / max(cfg.total_steps - a1, 1))

    return sched


def one_cycle_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """lr(step) with `OneCycle`'s phase boundaries: cosine from lr_max/div
    up to lr_max over pct_start, then down to lr_max/div/1e4."""
    low = cfg.lr_max / cfg.div_factor
    return _one_cycle(cfg, low, cfg.lr_max, low / 1e4)


def one_cycle_momentum_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """beta1(step): moms[0] -> moms[1] -> moms[0], counter to the lr."""
    m0, m1 = cfg.moms
    return _one_cycle(cfg, m0, m1, m0)


def exponential_decay_schedule(initial_lr: float, total_steps: int, decay_length: float,
                               decay_factor: float, staircase: bool = True):
    """`ExponentialDecay` (`learning_schedules_fastai.py:96-150`)."""
    steps_per_decay = max(int(decay_length * total_steps), 1)

    def sched(step: int) -> float:
        p = step / steps_per_decay
        return initial_lr * decay_factor ** (math.floor(p) if staircase else p)

    return sched


def manual_stepping_schedule(boundaries: Sequence[float], rates: Sequence[float],
                             total_steps: int):
    """`ManualStepping` (`learning_schedules_fastai.py:152-176`)."""
    bounds = [int(b * total_steps) for b in boundaries]

    def sched(step: int) -> float:
        return rates[sum(step >= b for b in bounds)]

    return sched


def trainable_mask(model: nn.Module, patterns: Sequence[str]) -> Dict[str, bool]:
    """Parameter name -> True (trained) where no regex matches the
    parameter's flax path."""
    regexes = [re.compile(p) for p in patterns]
    return {name: not any(r.search(path) for r in regexes)
            for name, path in flax_paths(model).items()}


def freeze_mask(model: nn.Module, patterns: Sequence[str]) -> Dict[str, bool]:
    """The JAX package's `freeze_mask(params, patterns)` over the port's
    model: True (trained) where no regex matches the '/'-joined flax path
    of the parameter; every parameter is trained without patterns."""
    return trainable_mask(model, patterns)


class ScheduledAdam:
    """The JAX package's `build_optimizer` chain over the trainable
    parameters of a model (see the module docstring).

    `step()` applies one update from the parameters' `.grad` (clipped in
    place) and advances `count`; `state_dict()` / `load_state_dict()` hold
    the Adam moments and `count`.
    """

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        self.cfg = cfg
        self.lr = one_cycle_schedule(cfg)
        self.mom = one_cycle_momentum_schedule(cfg)
        mask = trainable_mask(model, cfg.freeze_patterns)
        self.params = [p for name, p in model.named_parameters() if mask[name]]
        self.frozen = sorted(name for name, keep in mask.items() if not keep)
        self.adam = torch.optim.AdamW(self.params, lr=self.lr(0), betas=(self.mom(0), 0.99),
                                      eps=1e-8, weight_decay=cfg.weight_decay)
        self.count = 0

    def step(self):
        """One update at the schedules' values for `count`."""
        grads = [p.grad for p in self.params]
        safe_clip_by_global_norm(grads, self.cfg.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.lr(self.count)
            group["betas"] = (self.mom(self.count), 0.99)
        self.adam.step()
        self.count += 1

    def state_dict(self):
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def build_optimizer(cfg: OptimizerConfig, model: nn.Module) -> ScheduledAdam:
    """Adam + decoupled weight decay + OneCycle lr/momentum + clip, over the
    parameters of `model` that `cfg.freeze_patterns` leaves trainable."""
    return ScheduledAdam(cfg, model)
