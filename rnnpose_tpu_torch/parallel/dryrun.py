"""A data-parallel training step over N processes, checked against one
process (port of `__graft_entry__.dryrun_multichip`).

`dryrun_multichip(n)` starts n gloo processes on `device` (all on one card,
or on the CPU), under deterministic algorithms with TF32 off. Each joins
the process group, takes its `shard_batch` part of one global batch of n
items (or of the given `inputs`), and runs real `Trainer` steps, whose
gradients and loss terms are averaged in one flat all-reduce. Rank 0 first
computes, on the same weights and with no collective, the gradient of the
whole batch and the loss terms of each of its `shard_batch` parts alone.
Then:
  * the data-parallel loss of the first step against the single-process
    one: relative error under 1e-3;
  * the data-parallel loss against the mean of the parts' losses, the
    same forwards without the collective: relative error under 1e-6
    (the f32 average's rounding). The single-process loss against that
    mean, per loss term, is returned (`batch_rel_err`): it is how far a
    batch of n rounds apart from n batches of 1, not a bound;
  * the averaged gradient vector against the single-process one: cosine
    above 0.9999, norm ratio within 1 +- 1e-3 (the bounds of the JAX
    package's `tests/test_parallel_equivalence.py`);
  * after the last step the parameters of every rank bitwise equal.
A bound that fails raises RuntimeError; so does a process that fails or
outlives `timeout_s`. It returns those numbers with, per rank, the kernel
launches during the steps and ms per step, and the gradient buffer's bytes
and the all-reduce's ms on it (timed alone after the steps).

Run as a module it is one worker: `python -m rnnpose_tpu_torch.parallel.dryrun
<spec> <rank> <world> <host:port> <device>`.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["dryrun_multichip", "LOSS_RTOL", "MIN_COSINE", "NORM_RTOL", "SPLIT_RTOL"]

LOSS_RTOL, MIN_COSINE, NORM_RTOL, SPLIT_RTOL = 1e-3, 0.9999, 1e-3, 1e-6
ALLREDUCE_REPEATS = 5


def _default_setup(n: int):
    """The training CLI's small synthetic scene with n items, f32, one
    render iteration, and a model of seeded random weights for it."""
    import argparse

    from ..config.defaults import build_model_config, default_config
    from ..models.rnnpose import RNNPose, init_random_
    from ..tools.train import synthetic_setup

    args = argparse.Namespace(syn_image_size=64, syn_zoom=32)
    inputs, cfg = synthetic_setup(args, build_model_config(default_config()), "cpu",
                                  batch_size=n)
    cfg = dataclasses.replace(cfg, refiner=dataclasses.replace(
        cfg.refiner, render_iters=1, mixed_precision=False))
    return init_random_(RNNPose(cfg), torch.Generator().manual_seed(0)), inputs


def dryrun_multichip(n_devices: int, device: str = "cpu", model=None, inputs=None,
                     steps: int = 1, return_grads: bool = False,
                     timeout_s: float = 900.0) -> Dict[str, Any]:
    """See the module docstring. `model` and `inputs` default to the small
    synthetic scene (`inputs` must hold a multiple of `n_devices` items);
    the optimizer is `OptimizerConfig(total_steps=100)`'s; `return_grads`
    adds the averaged gradients of the first step by parameter name
    (`grads`)."""
    from .mesh import launch_local, map_tensors

    if model is None:
        model, inputs = _default_setup(n_devices)
    B = inputs.image.shape[0]
    if B % n_devices:
        raise ValueError(f"a batch of {B} does not split over {n_devices} processes")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        spec = os.path.join(work, "spec.pt")
        torch.save({
            "cfg": model.cfg, "plain_raster": model.motion_net.plain_raster,
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "inputs": map_tensors(lambda t: t.detach().cpu(), inputs),
            "steps": steps, "return_grads": return_grads,
        }, spec)
        launch_local(lambda r, addr: [sys.executable, "-m", "rnnpose_tpu_torch.parallel.dryrun",
                                      spec, str(r), str(n_devices), addr, device],
                     n_devices, work, timeout_s)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        out = dict(ranks[0]["check"], n_devices=n_devices, device=device, batch=B,
                   launches=[x["launches"] for x in ranks],
                   ms_per_step=[x["ms_per_step"] for x in ranks],
                   allreduce_bytes=ranks[0]["allreduce_bytes"],
                   allreduce_ms=[x["allreduce_ms"] for x in ranks])
        if return_grads:
            out["grads"] = torch.load(os.path.join(work, "grads.pt"), weights_only=True)
    bad = []
    if not out["loss_rel_err"] <= LOSS_RTOL:
        bad.append(f"loss {out['loss_dp']} vs {out['loss_single']}")
    if not out["split_rel_err"] <= SPLIT_RTOL:
        bad.append(f"loss {out['loss_dp']} vs the parts' mean {out['loss_split']}")
    if not out["grad_cosine"] > MIN_COSINE:
        bad.append(f"gradient cosine {out['grad_cosine']}")
    if not abs(out["grad_norm_ratio"] - 1.0) <= NORM_RTOL:
        bad.append(f"gradient norm ratio {out['grad_norm_ratio']}")
    if not out["params_equal"]:
        bad.append("the ranks' parameters differ after the step")
    if bad:
        raise RuntimeError(f"dryrun_multichip({n_devices}, {device!r}): " + "; ".join(bad))
    return out


def _flat_grads(params):
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params]).double()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _worker(spec_path: str, rank: int, world: int, addr: str, device: str):
    import torch.distributed as dist

    from ..models.rnnpose import RNNPose
    from .. import kernels
    from ..train.loop import METRICS, Trainer
    from ..train.optim import OptimizerConfig
    from . import mesh

    if device == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    spec = torch.load(spec_path, weights_only=False)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.init_distributed(addr, world, rank, backend="gloo", device=device)
    model = RNNPose(spec["cfg"], plain_raster=spec["plain_raster"])
    model.load_state_dict(spec["state"])
    model.to(dev)
    inputs = mesh.map_tensors(lambda t: t.to(dev), spec["inputs"])
    B = inputs.image.shape[0]

    check: Optional[Dict[str, Any]] = None
    if rank == 0:
        # The single-process gradient of the whole batch and the loss terms
        # of its parts, no collective.
        single = copy.deepcopy(model)
        out = single(inputs, train=True)
        out["loss"].backward()
        terms_single = {k: float(out[k]) for k in METRICS}
        g_single = _flat_grads(single.parameters()).cpu()
        del out
        parts = [single(mesh.shard_batch(inputs, B, rank=r, world=world), train=True)
                 for r in range(world)]
        terms_split = {k: sum(float(o[k]) for o in parts) / world for k in METRICS}
        del single, parts
    mesh.barrier()

    trainer = Trainer(model, OptimizerConfig(total_steps=100))
    params = list(model.parameters())
    # The averaged gradients as the update receives them (it clips them in
    # place).
    seen = []
    optimizer = trainer.state.optimizer
    update = optimizer.step

    def snapshot_then_update(*args, **kwargs):
        if not seen:
            seen.append({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()})
        return update(*args, **kwargs)

    optimizer.step = snapshot_then_update
    mine = mesh.shard_batch(inputs, B)
    before = kernels.LAUNCHES.copy()
    step_ms = []
    for i in range(spec["steps"]):
        _sync(dev)
        t0 = time.perf_counter()
        metrics = trainer.run_step(mine)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            loss_dp = float(metrics["loss"])
            if not seen:  # a skipped (non-finite) step does not update
                seen.append({n: p.grad.detach().cpu().clone()
                             for n, p in model.named_parameters()})
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.OPERATORS}

    flat = torch.cat([p.grad.reshape(-1) for p in params])
    reduce_ms = []
    for _ in range(ALLREDUCE_REPEATS):
        mesh.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        _sync(dev)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    digest = hashlib.sha256()
    for p in params:
        digest.update(p.detach().cpu().numpy().tobytes())
    digests = mesh.all_gather_object(digest.hexdigest())
    if rank == 0:
        g_dp = torch.cat([g.reshape(-1) for g in seen[0].values()]).double()
        if spec["return_grads"]:
            torch.save(seen[0], os.path.join(os.path.dirname(spec_path), "grads.pt"))
        cos = float(g_dp @ g_single / (g_dp.norm() * g_single.norm()))
        loss_single, loss_split = terms_single["loss"], terms_split["loss"]
        check = dict(loss_dp=loss_dp, loss_single=loss_single, loss_split=loss_split,
                     loss_rel_err=abs(loss_dp - loss_single) / max(abs(loss_single), 1e-30),
                     split_rel_err=abs(loss_dp - loss_split) / max(abs(loss_split), 1e-30),
                     batch_rel_err={k: abs(terms_single[k] - v) / max(abs(v), 1e-30)
                                    for k, v in terms_split.items()},
                     grad_cosine=cos, grad_norm_ratio=float(g_dp.norm() / g_single.norm()),
                     grad_norm=float(g_single.norm()), params_equal=len(set(digests)) == 1,
                     num_params=int(g_single.numel()))
    with open(os.path.join(os.path.dirname(spec_path), f"rank{rank}.json"), "w") as f:
        json.dump({"check": check, "launches": launches, "ms_per_step": step_ms,
                   "allreduce_bytes": flat.numel() * flat.element_size(),
                   "allreduce_ms": reduce_ms}, f)
    mesh.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
