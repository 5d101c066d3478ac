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
`DeviceAdam` applies the chain with `torch._foreach_*` ops in optax's
order, on tensors on the parameters' device and with no read on the host,
so a CUDA graph can hold it. `count`, the number of applied updates as the
optax state counts them, is an int32 0-d tensor there too (optax's count
dtype): a step the train loop skips does not advance it, and only the
device knows whether a step was skipped. lr(count) and beta1(count) are
computed from it in f32 on the device, with the JAX package's formulas in
the form XLA's CPU backend gives them (`geometry/precise.py`: the phase
fraction a multiply by the constant's f32 reciprocal, the cosine's
`end + c * (cos + 1)` one fused multiply-add; the cosine itself is a
transcendental and rounds as each device's library rounds it). The
host-side schedules (`one_cycle_schedule` etc.) stay for callers that want
a number. `step(finite)` computes the update and then keeps it only where
`finite` (a 0-d bool tensor) holds: every parameter, moment and `count`
is `torch.where(finite, new, old)`, as the JAX train step selects.

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
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..geometry.precise import fma, recip

__all__ = [
    "OptimizerConfig",
    "one_cycle_schedule",
    "one_cycle_momentum_schedule",
    "one_cycle_schedule_tensor",
    "one_cycle_momentum_schedule_tensor",
    "exponential_decay_schedule",
    "manual_stepping_schedule",
    "safe_global_norm",
    "safe_clip_by_global_norm",
    "trainable_mask",
    "freeze_mask",
    "DeviceAdam",
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
    # A tensor divided by a tensor: one rounding, as jnp divides (`max_norm / norm`
    # would be `norm.reciprocal() * max_norm` in torch).
    factor = torch.where(norm > max_norm, torch.full_like(norm, max_norm) / norm,
                         torch.ones_like(norm))
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


def _one_cycle_tensor(cfg: OptimizerConfig, first: float, peak: float, last: float):
    """The JAX package's `_annealing_cos` phases on a count tensor, in f32
    (its jitted rounding: `x / d` is `x * f32(1 / d)`, `end + c * cos_out`
    one fused multiply-add)."""
    a1 = int(cfg.total_steps * cfg.pct_start)
    r_up, r_down = recip(max(a1, 1)), recip(max(cfg.total_steps - a1, 1))
    pi = float(np.float32(math.pi))

    def annealing_cos(start, end, pct):
        cos_out = torch.cos(pct * pi) + 1.0
        return fma((start - end) / 2.0, cos_out, end)

    def sched(count: torch.Tensor) -> torch.Tensor:
        step = count.float()
        up = annealing_cos(first, peak, step * r_up)
        down = annealing_cos(peak, last, (step - a1) * r_down)
        return torch.where(step < a1, up, down)

    return sched


def one_cycle_schedule_tensor(cfg: OptimizerConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """`one_cycle_schedule` on the device: count (0-d int tensor) -> lr (f32)."""
    low = cfg.lr_max / cfg.div_factor
    return _one_cycle_tensor(cfg, low, cfg.lr_max, low / 1e4)


def one_cycle_momentum_schedule_tensor(cfg: OptimizerConfig):
    """`one_cycle_momentum_schedule` on the device: count -> beta1 (f32)."""
    m0, m1 = cfg.moms
    return _one_cycle_tensor(cfg, m0, m1, m0)


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
    if patterns:
        raise ValueError("the reference trains every parameter (no freeze patterns)")
    return {name: True for name, _ in model.named_parameters()}


def freeze_mask(model: nn.Module, patterns: Sequence[str]) -> Dict[str, bool]:
    """The JAX package's `freeze_mask(params, patterns)` over the port's
    model: True (trained) where no regex matches the '/'-joined flax path
    of the parameter; every parameter is trained without patterns."""
    return trainable_mask(model, patterns)


class DeviceAdam:
    """Clip, Adam, decoupled weight decay and scale(-lr) over `params`, on
    their device (see the module docstring): optax's `chain(
    safe_clip_by_global_norm(clip), scale_by_adam(beta1(count), b2, eps),
    add_decayed_weights(weight_decay), scale(-lr(count)))`. `lr` and
    `beta1` map the count tensor to an f32 0-d tensor on its device.

    `step(finite)` applies one update from the parameters' `.grad`
    (clipped in place) where `finite` holds and advances `count` there;
    `state_dict()` keeps the layout of `torch.optim.AdamW`'s under "adam"
    (moments `exp_avg` and `exp_avg_sq`) beside "count", so checkpoints of
    either load into the other.
    """

    def __init__(self, params: Sequence[torch.Tensor], lr, beta1, b2: float, eps: float,
                 weight_decay: float, clip: float):
        self.params = list(params)
        self.lr_at, self.beta1_at = lr, beta1
        # Numeric hyperparameters are f32 arrays in the optax state.
        self.b2, self.eps = float(np.float32(b2)), float(np.float32(eps))
        self.one_minus_b2 = float(np.float32(1.0) - np.float32(b2))
        self.weight_decay, self.clip = float(np.float32(weight_decay)), clip
        device = self.params[0].device if self.params else torch.device("cpu")
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    @torch.no_grad()
    def step(self, finite: Optional[torch.Tensor] = None):
        """One update at the schedules' values for `count`, kept where the
        0-d bool tensor `finite` holds (always, when it is None)."""
        if not self.params:
            return
        params = self.params
        grads = [p.grad for p in params]
        safe_clip_by_global_norm(grads, self.clip)
        count = self.count
        b1 = self.beta1_at(count)
        lr = self.lr_at(count)
        # optax.scale_by_adam: the moments, then the bias corrections with
        # the current beta1 at count + 1.
        m = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(m, torch._foreach_mul(self.m, b1))
        v = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(v, self.one_minus_b2)
        torch._foreach_add_(v, torch._foreach_mul(self.v, self.b2))
        count_inc = count + 1
        bc1 = 1.0 - torch.pow(b1, count_inc)
        bc2 = 1.0 - torch.pow(torch.full_like(b1, self.b2), count_inc)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, den)
        # optax.add_decayed_weights, optax.scale(-lr), optax.apply_updates.
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(u, -lr)
        new_p = torch._foreach_add(params, u)
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=count.device)
        for olds, news in ((params, new_p), (self.m, m), (self.v, v)):
            for old, new in zip(olds, news):
                torch.where(finite, new, old, out=old)
        torch.where(finite, count_inc, count, out=count)

    def state_dict(self):
        """{"adam": AdamW's layout (references to the moments), "count": int}."""
        n = int(self.count)
        lr, b1 = float(self.lr_at(self.count)), float(self.beta1_at(self.count))
        state = {i: {"step": torch.tensor(float(n)), "exp_avg": m, "exp_avg_sq": v}
                 for i, (m, v) in enumerate(zip(self.m, self.v))} if n else {}
        group = {"lr": lr, "betas": (b1, self.b2), "eps": self.eps,
                 "weight_decay": self.weight_decay, "amsgrad": False,
                 "params": list(range(len(self.params)))}
        return {"adam": {"state": state, "param_groups": [group]}, "count": n}

    def load_state_dict(self, state):
        """Copy a `state_dict()` (this class's or one written by the
        AdamW-based optimizer before it) into the tensors `step` reads."""
        adam = state["adam"]
        n = sum(len(g["params"]) for g in adam["param_groups"])
        if n != len(self.params):
            raise ValueError(f"the state holds {n} parameters, the optimizer {len(self.params)}")
        for i, (m, v) in enumerate(zip(self.m, self.v)):
            st = adam["state"].get(i)
            if st is None:  # AdamW makes a parameter's state at its first update
                m.zero_()
                v.zero_()
            else:
                m.copy_(st["exp_avg"])
                v.copy_(st["exp_avg_sq"])
        self.count.fill_(int(state["count"]))


class ScheduledAdam(DeviceAdam):
    """The JAX package's `build_optimizer` chain over the trainable
    parameters of a model: OneCycle lr and beta1 on the device, beta2 0.99,
    eps 1e-8; `lr` and `mom` are the host-side schedules of the same
    numbers."""

    def __init__(self, cfg: OptimizerConfig, model: nn.Module):
        self.cfg = cfg
        self.lr = one_cycle_schedule(cfg)
        self.mom = one_cycle_momentum_schedule(cfg)
        mask = trainable_mask(model, cfg.freeze_patterns)
        self.frozen = sorted(name for name, keep in mask.items() if not keep)
        super().__init__([p for name, p in model.named_parameters() if mask[name]],
                         lr=one_cycle_schedule_tensor(cfg),
                         beta1=one_cycle_momentum_schedule_tensor(cfg), b2=0.99, eps=1e-8,
                         weight_decay=cfg.weight_decay, clip=cfg.grad_clip)


def build_optimizer(cfg: OptimizerConfig, model: nn.Module) -> ScheduledAdam:
    """Adam + decoupled weight decay + OneCycle lr/momentum + clip, over the
    parameters of `model` that `cfg.freeze_patterns` leaves trainable."""
    return ScheduledAdam(cfg, model)
