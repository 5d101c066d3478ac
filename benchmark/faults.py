"""Faults planted in the timed path, for the tests and for the readings
that set a training cell's limits (`control.py --fault`). Each is a factory
`fault(fn, owner) -> fn'` over the engine's `refine` (owner: the engine) or
the trainer's `run_step` (owner: the trainer). Every serving request the
check samples is a replay of the captured graph; a training fault acts only
once the trainer has captured its graphs (`graph_captures` above 0 at the
call), so it breaks the replays and leaves the eager warm-ups sound. No
cell runs across chips, so no exchange between chips can be left out."""
from __future__ import annotations

import torch

from .reference.geometry.se3 import se3_expm

__all__ = ["SERVING", "TRAINING"]


def serving_unchanged(refine, engine):
    """The refinement returns its state unchanged: every pose is the start."""
    def fn(cls, inputs):
        out = refine(cls, inputs)
        ref = out["refiner"]
        start = inputs.T_init[None].expand_as(ref.Ti_history)
        out["refiner"] = ref._replace(Ti_history=start.clone(),
                                      flow_history=torch.zeros_like(ref.flow_history))
        out["Ti_pred"] = inputs.T_init.clone()
        return out
    return fn


def serving_half(refine, engine):
    """Half of the batch left out: the second half's outputs are the first's."""
    def fn(cls, inputs):
        out = refine(cls, inputs)
        h = inputs.image.shape[0] // 2
        ref = out["refiner"]

        def fold(t, axis):
            t = t.clone()
            idx = [slice(None)] * t.dim()
            src = list(idx)
            idx[axis], src[axis] = slice(h, 2 * h), slice(0, h)
            t[tuple(idx)] = t[tuple(src)]
            return t
        out["refiner"] = ref._replace(Ti_history=fold(ref.Ti_history, 1),
                                      flow_history=fold(ref.flow_history, 1))
        out["Ti_pred"] = fold(out["Ti_pred"], 0)
        return out
    return fn


def serving_altered(refine, engine):
    """The answer altered where it is produced: Ti_pred moved by 1 cm."""
    def fn(cls, inputs):
        out = refine(cls, inputs)
        xi = torch.zeros(inputs.T_init.shape[0], 6, device=inputs.T_init.device)
        xi[:, 0] = 1e-2
        out["Ti_pred"] = se3_expm(xi) @ out["Ti_pred"]
        return out
    return fn


def _replayed(trainer) -> bool:
    return trainer.graph_captures > 0


def train_unchanged(step, trainer):
    """A replayed step that returns its state unchanged."""
    def fn(batch):
        if not _replayed(trainer):
            return step(batch)
        before = [p.detach().clone() for p in trainer.model.parameters()]
        m = step(batch)
        with torch.no_grad():
            for p, b in zip(trainer.model.parameters(), before):
                p.copy_(b)
        return m
    return fn


def _half(batch):
    """The batch with its second half replaced by its first: the same
    shapes (the same captured graph), the mean taken over the first half."""
    h = batch.image.shape[0] // 2

    def fold(t):
        return torch.cat([t[:h], t[:h]])
    pyr = batch.pyramid
    return batch._replace(
        image=fold(batch.image), intrinsics=fold(batch.intrinsics), T_init=fold(batch.T_init),
        T_gt=fold(batch.T_gt), model_points=fold(batch.model_points),
        point_valid=fold(batch.point_valid),
        pyramid=type(pyr)(*([fold(t) for t in ts] for ts in (
            pyr.points, pyr.masks, pyr.neighbors, pyr.pools, pyr.upsamples))),
        corr=type(batch.corr)(*(fold(t) for t in batch.corr)))


def train_half(step, trainer):
    """Half of the batch left out of a replayed step."""
    return lambda batch: step(_half(batch) if _replayed(trainer) else batch)


def train_altered(step, trainer):
    """The answer altered where it is produced: a replayed step's loss
    reported 10% high."""
    def fn(batch):
        replayed = _replayed(trainer)
        m = step(batch)
        if replayed:
            m["loss"] = m["loss"] * 1.1
        return m
    return fn


SERVING = {"unchanged": serving_unchanged, "half": serving_half, "altered": serving_altered}
TRAINING = {"unchanged": train_unchanged, "half": train_half, "altered": train_altered}
