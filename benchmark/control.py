"""Readings that set a cell's limits, on the chip: sound runs of the
program and the lower-precision control, judged by the same comparison.

  python3 -m benchmark.control --workload <cell> --seeds 1 2 ... \
      [--control_seeds 7 8 9] [--fault half] [--seconds 3] [--out readings.jsonl]

For each of `--seeds` it runs the cell as `benchmark.run` does, with a
`--seconds` window (the lower readings). For each of `--control_seeds` it
puts the control in the program's place and judges it alike (the upper
readings): the reference computed in the nearest precision below the one
the configuration states. A configuration in mixed precision computes its
2D nets' convolutions in bf16, so the control rounds their inputs and
weights to float8 e4m3 (`reference/models/raft._fp8_round`); a float32
configuration with TF32 off gets TF32 on. A serving control refines the
cell's first `check_sample` requests of the seed's stream, the full
budget from each request's initial pose; a training control takes the
cell's compared steps, both phases. With `--fault` the program runs of `--seeds` have
that fault of `faults.py` planted in the timed path (a training cell's
upper readings are also the faults'). One JSON line per run. The
harness's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import build, check, faults, gen, serve, train
from .run import ROOT, _set_caches, run_cell
from .spec import load_spec

__all__ = ["fp8_control", "serving_control", "training_control"]


def fp8_control(model) -> None:
    """Round the inputs and weights of every convolution that computes in
    a lower dtype (the configuration's bf16 ones) to float8."""
    from .reference.models.raft import Conv

    for m in model.modules():
        if isinstance(m, Conv) and m.compute_dtype is not None:
            m.fp8 = True


def _control_model(cfg, weights, device, render_iters=None):
    mods = build.side("reference")
    if cfg["mixed_precision"]:
        check.exact_f32()
        model = build.build_model(mods, cfg, device, render_iters=render_iters).eval()
        fp8_control(model)
    else:
        check.exact_f32(tf32=True)
        model = build.build_model(mods, cfg, device, f32=True, render_iters=render_iters).eval()
    build.load_weights(model, weights)
    return model


@torch.no_grad()
def serving_control(cfg, traffic, seed, device):
    """The serving numbers of the control in the program's place."""
    s = gen.seeds(seed)
    B = traffic["batch"]
    mods = build.side("reference")
    scene = gen.make_scene(cfg, B, s["scene"], device)
    weights = gen.make_weights(build.build_model(mods, cfg, "meta"), s["weights"], device)
    model = _control_model(cfg, weights, device)
    base = gen.as_inputs(mods, scene)
    d3, c3 = model.encode_3d(base.pyramid)
    requests = serve.Requests(traffic, scene, s["requests"])
    samples, prev = [], None
    for _ in range(traffic["check_sample"]):
        T, image = requests.next(prev)
        out = model(base._replace(T_init=T, image=image), cached_desc3d=d3, cached_ctx3d=c3)
        prev = out["Ti_pred"]
        samples.append(dict(T_init=T, image=image, Ti_pred=out["Ti_pred"],
                            Ti_history=out["refiner"].Ti_history,
                            Tij_history=out["refiner"].Tij_history,
                            flow_history=out["refiner"].flow_history))
    del model
    return check.check_serving(cfg, scene, weights, samples, device)


def training_control(cfg, traffic, seed, device):
    """The training numbers of the control in the program's place: both
    phases of its steps, each judged from the state the control started it
    from."""
    if not cfg["mixed_precision"]:
        raise NotImplementedError("a float32 training configuration's control is TF32")
    s = gen.seeds(seed)
    mods = build.side("reference")
    scene = gen.make_scene(cfg, traffic["batch"], s["scene"], device)
    weights = gen.make_weights(build.build_model(mods, cfg, "meta"), s["weights"], device)
    got = dict(scene=scene, weights=weights,
               pool=train.make_pool(traffic, scene, s["requests"] % (2 ** 31)))
    ctl = train.reference_steps(cfg, got, traffic, device, control=fp8_control)
    return train.judge_records(cfg, got, traffic, device, ctl)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="lower and upper readings of a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(faults.SERVING), default=None)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    _set_caches()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = load_spec(ROOT)
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    rows = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for way, seed in rows:
        t0 = time.perf_counter()
        if way == "program":
            table = faults.SERVING if traffic["kind"] == "serve" else faults.TRAINING
            hooks = {"fault": table[args.fault]} if args.fault else None
            res = run_cell(spec, args.workload, seed, args.seconds, False, dev, t_start=t0,
                           hooks=hooks)
            numbers = dict(res["numbers"], **{k: v["value"] for k, v in res["limits"].items()})
            extra = {"metrics": res["metrics"], "correct": res["correct"]}
        else:
            fn = serving_control if traffic["kind"] == "serve" else training_control
            numbers, extra = fn(cfg, traffic, seed, dev), {}
            numbers.pop("items", None)
        row = dict(workload=args.workload, way=way if not args.fault or way == "control"
                   else f"fault:{args.fault}", seed=seed, numbers=numbers,
                   seconds=time.perf_counter() - t0, **extra)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(line + "\n")
        torch.cuda.empty_cache()
    check.exact_f32()
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
