"""Training cells: the program's `Trainer.run_step` in a closed loop.

Set-up builds the scene, the weights and a pool of `pool` distinct batches
from the seed (each a fresh rigid jitter of the initial poses, fresh image
noise and its own correspondence set), the program's model and `Trainer`,
and takes the compared steps through `run_step`, each on its own batch of
the pool, in two phases (`PHASES`):

* `start`: the first `check_steps` steps from the seed's weights: the
  key's eager warm-ups, then the step that captures its graphs;
* `replay`: the next `replay_steps` steps, every one a replay of the
  captured graphs, from the state the first phase left.

Each phase records what the check compares (`record`): every step's loss
terms and gradient norm, the parameters, both moments and the update count
at the phase's start and end, and in the first phase the gradient as the
optimizer got it at step 1 (its first moment over 1 - beta1). The records
are host copies, so they take no device memory. The window then steps
through the pool, cycling, with no host read; it closes on a synchronise,
so it holds all the work it launched. CUDA events around each step give
the device's gaps between steps (`readers.idle_share`).
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import record_function

from . import build, check, gen, serve
from .reference.geometry.se3 import se3_expm

__all__ = ["PHASES", "make_pool", "phase_batches", "run", "follow", "reference_steps",
           "judge_records", "judge"]

PHASES = ("start", "replay")
TERMS = ("loss", "circle_loss", "flow_loss", "loss_3d_proj", "grad_norm")


def make_pool(traffic: Dict[str, Any], scene: gen.Scene, seed: int) -> List[Dict[str, Any]]:
    """`traffic["pool"]` distinct batches over the scene: dicts of T_init,
    image and corr (plain tensors on the scene's device)."""
    dev = scene.image.device
    g = torch.Generator(device=dev).manual_seed(seed)
    B = scene.image.shape[0]
    scale = torch.tensor([traffic["jitter_trans"]] * 3 + [traffic["jitter_rot"]] * 3, device=dev)
    pool = []
    for k in range(traffic["pool"]):
        xi = torch.randn(B, 6, generator=g, device=dev) * scale
        noise = torch.rand(scene.image.shape, generator=g, device=dev)
        pool.append(dict(T_init=se3_expm(xi) @ scene.T_init,
                         image=(scene.image + traffic["image_noise"] * noise).clamp(0.0, 1.0),
                         corr=gen.make_corr(scene, traffic["num_corr"], seed + 1 + k)))
    return pool


def phase_batches(traffic: Dict[str, Any]) -> Dict[str, range]:
    """The pool's batches each phase steps on (all distinct)."""
    C, R = traffic["check_steps"], traffic["replay_steps"]
    if C + R > traffic["pool"]:
        raise ValueError("the compared steps need a distinct batch each")
    return {"start": range(0, C), "replay": range(C, C + R)}


def state(model, opt) -> Dict[str, Any]:
    """Host copies of the parameters (by name), both moments and the count."""
    names = [n for n, _ in model.named_parameters()]

    def host(ts):
        return {n: t.detach().to("cpu", copy=True) for n, t in zip(names, ts)}
    return {"params": host(model.parameters()), "m": host(opt.m), "v": host(opt.v),
            "count": int(opt.count)}


def record(step, model, opt, batches, first_grad: bool) -> Dict[str, Any]:
    """Take `step` on each batch: {"begin": state, "steps": [{term: float}],
    "end": state[, "grad": the gradient as the optimizer got it at the first
    step]}."""
    names = [n for n, _ in model.named_parameters()]
    if len(opt.params) != len(names):
        raise RuntimeError("the optimizer does not hold every parameter")
    rec: Dict[str, Any] = {"begin": state(model, opt), "steps": []}
    for i, b in enumerate(batches):
        beta1 = float(opt.beta1_at(opt.count))
        m = step(b)
        rec["steps"].append({k: float(m[k]) for k in TERMS})
        if first_grad and i == 0:
            rec["grad"] = {n: mt.detach().to("cpu", copy=True) / (1.0 - beta1)
                           for n, mt in zip(names, opt.m)}
    rec["end"] = state(model, opt)
    return rec


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    from rnnpose_tpu_torch.train.loop import Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    s = gen.seeds(ctx["seed"])
    B = traffic["batch"]
    mods = build.side("program")
    scene = gen.make_scene(cfg, B, s["scene"], dev)
    model = build.build_model(mods, cfg, dev)
    weights = gen.make_weights(model, s["weights"], dev)
    build.load_weights(model, weights)
    trainer = Trainer(model, OptimizerConfig())
    pool = make_pool(traffic, scene, s["requests"] % (2 ** 31))
    serve._reset_peak(dev)  # the scene's render is the benchmark's, not the program's
    batches = [gen.as_inputs(mods, scene, b["image"], b["T_init"], b["corr"]) for b in pool]
    step = trainer.run_step
    if "fault" in ctx:  # the tests plant faults in the timed path here
        step = ctx["fault"](step, trainer)
    opt = trainer.state.optimizer

    t_built = time.perf_counter()
    ranges = phase_batches(traffic)
    rec = {}
    for phase in PHASES:
        rec[phase] = record(step, model, opt, [batches[i] for i in ranges[phase]],
                            first_grad=phase == "start")
        if phase == "start":
            captures = trainer.graph_captures
    k = ranges["replay"].stop
    _sync(dev)
    setup_s = time.perf_counter() - ctx["t_start"]
    print(f"setup: {t_built - ctx['t_start']:.3f} s to the built model, scene and pool, "
          f"compared steps (warm-ups, capture, replays) {setup_s - (t_built - ctx['t_start']):.3f}"
          " s", file=sys.stderr)

    host_ms: List[float] = []
    losses = []
    spans = serve.Spans(dev)
    n = 0
    t0 = time.perf_counter()
    spans.open()
    while time.perf_counter() - t0 < ctx["seconds"]:
        t_call = time.perf_counter()
        spans.begin()
        m = step(batches[k % len(batches)])
        spans.end()
        host_ms.append((time.perf_counter() - t_call) * 1e3)
        losses.append(torch.where(m["skipped_nonfinite"] > 0, float("nan"), m["loss"]))
        k += 1
        n += 1
    spans.close()
    _sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    readings = dict(kind="train", setup_s=setup_s, window_s=window_s, requests=n,
                    samples=n * B, host_ms=host_ms, failed=failed, memory_peak_bytes=peak,
                    new_captures=trainer.graph_captures - captures, batch=B,
                    call_gaps=spans.gaps())
    if ctx["trace"]:
        nt = traffic["trace_steps"]

        def traced():
            nonlocal k
            for _ in range(nt):
                with record_function("bench/step"):
                    step(batches[k % len(batches)])
                k += 1

        readings["traced"] = ctx["profile"](traced)
        readings["traced_samples"] = nt * B
    del trainer, model, batches, step, opt
    return dict(readings=readings, scene=scene, weights=weights, pool=pool, record=rec)


def follow(cfg, got, traffic, device, begin: Optional[Dict[str, Any]], phase: str,
           control=None) -> Dict[str, Any]:
    """The reference's record of `phase`'s steps on the same batches, from
    the seed's weights (`begin` None: fresh moments, count 0) or from the
    state `begin` (host copies of parameters, moments and count). `control`
    adjusts the reference model before its steps (the lower-precision
    control)."""
    from .reference.train.optim import OptimizerConfig, build_optimizer
    from .reference.train.step import make_train_step

    mods = build.side("reference")
    check.exact_f32()
    model = build.build_model(mods, cfg, device, f32=control is None)
    if control is not None:
        control(model)
    opt = build_optimizer(OptimizerConfig(), model)
    with torch.no_grad():
        if begin is None:
            build.load_weights(model, got["weights"])
        else:
            build.load_weights(model, {n: t.to(device) for n, t in begin["params"].items()})
            names = [n for n, _ in model.named_parameters()]
            for key in ("m", "v"):
                for n, t in zip(names, getattr(opt, key)):
                    t.copy_(begin[key][n])
            opt.count.fill_(begin["count"])
    batches = [gen.as_inputs(mods, got["scene"], got["pool"][i]["image"],
                             got["pool"][i]["T_init"], got["pool"][i]["corr"])
               for i in phase_batches(traffic)[phase]]
    rec = record(make_train_step(model, opt), model, opt, batches, first_grad=phase == "start")
    del model, opt
    return rec


def reference_steps(cfg, got, traffic, device, control=None) -> Dict[str, Any]:
    """A side's records of both phases, taken by the reference (with
    `control`, the control in the program's place): the first from the
    seed's weights, the second from the state the first left."""
    start = follow(cfg, got, traffic, device, None, "start", control)
    return {"start": start, "replay": follow(cfg, got, traffic, device, start["end"], "replay",
                                             control)}


def judge_records(cfg, got, traffic, device, side: Dict[str, Any]) -> Dict[str, float]:
    """The training numbers of a side's records: the reference follows each
    phase from the state that side started it from."""
    ref = {"start": follow(cfg, got, traffic, device, None, "start"),
           "replay": follow(cfg, got, traffic, device, side["start"]["end"], "replay")}
    return check.check_training(side, ref)


def flops_per_sample(cfg, got, traffic, device) -> float:
    """FlopCounterMode's count of one forward and backward of the reference
    at the cell's batch, per sample."""
    from torch.utils.flop_counter import FlopCounterMode

    mods = build.side("reference")
    check.exact_f32()
    model = build.build_model(mods, cfg, device, f32=True)
    build.load_weights(model, got["weights"])
    b = got["pool"][0]
    batch = gen.as_inputs(mods, got["scene"], b["image"], b["T_init"], b["corr"])
    with FlopCounterMode(display=False) as counter:
        model(batch, train=True)["loss"].backward()
    del model
    return counter.get_total_flops() / traffic["batch"]


def judge(ctx, got, trace: bool):
    """(the training numbers, FLOPs per sample or None)."""
    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    flops = flops_per_sample(cfg, got, traffic, dev) if trace else None
    return judge_records(cfg, got, traffic, dev, got["record"]), flops


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
