"""The `train_data` kind: training on a new object from LINEMOD-format files,
the program's `Trainer.run_step` fed by the program's own data path.

Set-up writes the traffic's data set from the seed under a fresh directory
in `TMPDIR` (`benchmark/gen_linemod.py`: PNG frames, depth, the OBJ model,
the `.info` files and the config), and reads every file once: a
deployment's object set stays in the page cache after its first epoch, so
the window does not measure a cold disk. It then builds what
`tools/train.main` builds from that config: the merged config (the
traffic's batch, and the configuration's crop, mesh budget and pyramid
neighbours in its `preprocess` block), the dataset
(`config.defaults.build_dataset`) and its batch stream
(`tools/train.dataset_batches`: the sampler, `sample_at` in
`loader_threads` threads of a `PrefetchLoader`, `collate_samples` onto the
card). The model takes the seed's weights and a `Trainer` the default
optimizer, as in the `train` kind, and the compared steps
(`benchmark/train.py`'s phases and records) run on the stream's first
batches, whose host copies are kept. The window then takes the next batch
and steps on it, with no host read; the host clock times each wait in
`next()`, and it closes on a synchronise. A seeded reservoir keeps
`check_sample` of the window's batches (references, copied to the host
once the window has closed).

The check (`judge`), with the program's state freed: the reference's
sample path (`benchmark/reference/data/linemod.py`) reads the same
(frame, stream position) pairs from the files, and

* the batch numbers hold each compared and sampled batch of the program
  against the reference's (`batch_gaps`; their limits, and why, are in the
  traffic file);
* the training numbers (`check.check_training`) hold the compared steps
  against the reference following them on its own batches, which the
  batch numbers hold equal to the program's.

The data directory is removed when the check is done, or at exit.

  python3 -m benchmark.runners.train_data --config rnnpose-linemod \
      --traffic train-data8 --control_seeds 7 8 9

prints the control's numbers (the reference in the program's place, one
precision below the configuration: bf16 images in the batches, float8
inputs and weights for the bf16 convolutions in the steps) as JSON lines;
the harness's own runs never run it.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import record_function

from benchmark import build, check, gen, gen_linemod, serve, train
from benchmark.reference.data import linemod as ref_linemod
from benchmark.reference.data.preprocess import PreprocessConfig

__all__ = ["run", "judge", "batch_gaps", "reference_batches", "control_numbers", "FAULTS"]

DATASET_SEED = 0   # `build_dataset` gives the training dataset seed 0
READERS = 4        # threads of the reference's sample path


def writer_params(cfg, traffic: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """The data set's parameters: the configuration's object (its size and
    distance), the traffic's frames and camera, the writer's seed drawn
    from `seed`."""
    p = dict(gen_linemod.DEFAULTS, **traffic["data"], object_scale=cfg["object_scale"],
             distance=cfg["distance"], seed=gen.seeds(seed)["scene"] % (2 ** 31))
    p["distance_range"] = tuple(p["distance_range"])
    return p


def write_data(cfg, traffic, seed, device) -> str:
    """The data set under a fresh directory of `TMPDIR`, removed at exit at
    the latest, every file read once; returns the config's path."""
    root = tempfile.mkdtemp(prefix="bench-linemod-")
    atexit.register(shutil.rmtree, root, True)
    path = gen_linemod.write(root, writer_params(cfg, traffic, seed), device)
    for d, _, files in os.walk(root):
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                f.read()
    return path


def preprocess_block(cfg, traffic) -> Dict[str, Any]:
    """The config's `preprocess` keys the cell sets: the configuration's
    crop (its image size), mesh budget and pyramid neighbours, the
    traffic's correspondence rows and any other key its `preprocess`
    names."""
    return dict(crop_size=cfg["image_size"], num_corr=traffic["num_corr"],
                max_verts=cfg["num_verts"], max_faces=cfg["num_faces"],
                neighbor_limits=[cfg["kp_neighbors"]] * cfg["kp_layers"],
                **traffic.get("preprocess", {}))


def _ranges(traffic) -> Dict[str, range]:
    """The stream's batches each phase of the compared steps takes."""
    C, R = traffic["check_steps"], traffic["replay_steps"]
    return {"start": range(0, C), "replay": range(C, C + R)}


def _host(batch):
    """A batch's tensors copied to the host, in the same types."""
    def cpu(t):
        return t.detach().to("cpu", copy=True)
    p = batch.pyramid
    return batch._replace(
        image=cpu(batch.image), intrinsics=cpu(batch.intrinsics), T_init=cpu(batch.T_init),
        T_gt=cpu(batch.T_gt), mesh=type(batch.mesh)(*(cpu(t) for t in batch.mesh)),
        model_points=cpu(batch.model_points), point_valid=cpu(batch.point_valid),
        pyramid=type(p)(*([cpu(t) for t in ts] for ts in (
            p.points, p.masks, p.neighbors, p.pools, p.upsamples))),
        corr=type(batch.corr)(*(cpu(t) for t in batch.corr)))


def swap_samples(dataset):
    """A fault: the first two samples of every batch swapped."""
    def swap(batch):
        order = torch.arange(batch.image.shape[0], device=batch.image.device)
        order[0], order[1] = 1, 0
        return batch._replace(image=batch.image[order], intrinsics=batch.intrinsics[order],
                              T_init=batch.T_init[order], T_gt=batch.T_gt[order],
                              corr=type(batch.corr)(*(t[order] for t in batch.corr)))
    return swap


def shift_position(dataset):
    """A fault: every sample's randomness drawn from the next stream
    position."""
    sample_at = dataset.sample_at
    dataset.sample_at = lambda idx, position: sample_at(idx, position + 1)
    return None


FAULTS = {"swap": swap_samples, "shift": shift_position}


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    from rnnpose_tpu_torch.config.defaults import build_dataset, default_config
    from rnnpose_tpu_torch.tools.train import dataset_batches
    from rnnpose_tpu_torch.utils.config_io import merge_cfg

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    s = gen.seeds(ctx["seed"])
    B = traffic["batch"]
    t0 = time.perf_counter()
    cfg_path = write_data(cfg, traffic, ctx["seed"], dev)
    serve._reset_peak(dev)  # the data set's renders are the benchmark's, not the program's
    t_written = time.perf_counter()

    mods = build.side("program")
    conf = merge_cfg([cfg_path], defaults=default_config())
    conf["train_input_reader"]["batch_size"] = B
    conf["train_input_reader"]["dataset"]["kwargs"]["preprocess"].update(
        preprocess_block(cfg, traffic))
    dataset = build_dataset(conf, build.model_config(mods, cfg).desc_kp, is_train=True)
    wrap = ctx["data_fault"](dataset) if "data_fault" in ctx else None
    loader = dataset_batches(dataset, conf, -1, traffic["loader_threads"], dev)
    it = iter(loader)

    def take():
        b = next(it)
        return b if wrap is None else wrap(b)

    try:
        return _steps(ctx, s, mods, take, cfg_path, t_written - t0)
    finally:
        loader.close()


def _steps(ctx, s, mods, take, cfg_path, write_s):
    """The model, the compared steps, the window and the traced stretch
    on the batches `take()` gives."""
    from rnnpose_tpu_torch.train.loop import Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    B = traffic["batch"]
    model = build.build_model(mods, cfg, dev)
    weights = gen.make_weights(model, s["weights"], dev)
    build.load_weights(model, weights)
    trainer = Trainer(model, OptimizerConfig())
    step = trainer.run_step
    if "fault" in ctx:  # the tests plant faults in the timed path here
        step = ctx["fault"](step, trainer)
    opt = trainer.state.optimizer

    t_built = time.perf_counter()
    ranges = _ranges(traffic)
    compared = [take() for _ in range(ranges["replay"].stop)]
    kept = {i: _host(b) for i, b in enumerate(compared)}
    rec = {}
    for phase in train.PHASES:
        rec[phase] = train.record(step, model, opt, [compared[i] for i in ranges[phase]],
                                  first_grad=phase == "start")
        if phase == "start":
            captures = trainer.graph_captures
    del compared
    k = ranges["replay"].stop
    train._sync(dev)
    setup_s = time.perf_counter() - ctx["t_start"]
    print(f"setup: {write_s:.3f} s to write and read the data set, "
          f"{t_built - ctx['t_start']:.3f} s to the built dataset, loader and model, compared "
          f"steps {setup_s - (t_built - ctx['t_start']):.3f} s", file=sys.stderr)

    host_ms: List[float] = []
    waits: List[float] = []
    losses = []
    sample = serve._Reservoir(traffic["check_sample"], s["check"])
    spans = serve.Spans(dev)
    n = 0
    t0 = time.perf_counter()
    spans.open()
    while time.perf_counter() - t0 < ctx["seconds"]:
        t_call = time.perf_counter()
        b = take()
        t_got = time.perf_counter()
        spans.begin()
        m = step(b)
        spans.end()
        host_ms.append((time.perf_counter() - t_got) * 1e3)
        waits.append((t_got - t_call) * 1e3)
        losses.append(torch.where(m["skipped_nonfinite"] > 0, float("nan"), m["loss"]))
        sample.offer(lambda: (k, b))
        k += 1
        n += 1
    spans.close()
    train._sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    kept.update((i, _host(batch)) for i, batch in sample.items)
    del sample
    readings = dict(kind="train", setup_s=setup_s, window_s=window_s, requests=n,
                    samples=n * B, host_ms=host_ms, loader_wait_ms=waits, failed=failed,
                    memory_peak_bytes=peak, new_captures=trainer.graph_captures - captures,
                    batch=B, call_gaps=spans.gaps())
    if ctx["trace"]:
        nt = traffic["trace_steps"]

        def traced():
            for _ in range(nt):
                with record_function("bench/step"):
                    step(take())

        readings["traced"] = ctx["profile"](traced)
        readings["traced_samples"] = nt * B
    del trainer, model, step, opt
    return dict(readings=readings, weights=weights, record=rec, kept=kept,
                data_root=os.path.dirname(cfg_path))


# ---- the check -------------------------------------------------------------

def reference_frames(cfg, traffic, root: str) -> ref_linemod.TrainFrames:
    """The reference's reader of the written training frames."""
    p = preprocess_block(cfg, traffic)
    cls = traffic["data"]["class_name"]
    return ref_linemod.TrainFrames(
        os.path.join(root, f"{cls}_train.info"), root, os.path.join(root, "models"),
        build.model_config(build.side("reference"), cfg).desc_kp,
        PreprocessConfig(**{f.name: p[f.name] for f in dataclasses.fields(PreprocessConfig)
                            if f.name in p}),
        p["neighbor_limits"], p["max_verts"], p["max_faces"], seed=DATASET_SEED)


def reference_batches(frames: ref_linemod.TrainFrames, indices, batch: int, device,
                      image_dtype=None) -> Dict[int, Any]:
    """{i: the reference's batch i of the stream} on `device`; with
    `image_dtype` the images are rounded to it (the control)."""
    jobs = [pair for i in indices for pair in frames.positions(i, batch)]
    frames.assets()
    with ThreadPoolExecutor(READERS) as pool:
        samples = list(pool.map(lambda pair: frames.sample_at(*pair), jobs))
    out = {}
    for j, i in enumerate(indices):
        b = ref_linemod.collate(frames, samples[j * batch:(j + 1) * batch], device)
        if image_dtype is not None:
            b = b._replace(image=b.image.to(image_dtype).float())
        out[i] = b
    return out


def _gap(a, b) -> float:
    """max |a - b| over two tensors (inf when their shapes differ)."""
    if a.shape != b.shape:
        return float("inf")
    if a.numel() == 0:
        return 0.0
    g = float((a.double() - b.double().to(a.device)).abs().max())
    return g if g == g else float("inf")


def _set_gap(a, b) -> float:
    """Rows of two index tables whose sets of indices differ (inf when the
    shapes differ): the pyramid's neighbours at equal distance may come in
    another order."""
    if a.shape != b.shape:
        return float("inf")
    sa, _ = a.reshape(-1, a.shape[-1]).sort(dim=-1)
    sb, _ = b.to(a.device).reshape(-1, b.shape[-1]).sort(dim=-1)
    return float((sa != sb).any(dim=-1).sum())


def batch_gaps(prog, ref) -> Dict[str, float]:
    """The batch numbers of one batch of the program against the
    reference's: the largest absolute gap of each group of fields, and the
    pyramid's index rows whose sets differ (with its masks' differing
    entries)."""
    pp, rp = prog.pyramid, ref.pyramid
    pairs = lambda xs, ys: list(zip(xs, ys))  # noqa: E731
    levels = (pairs(pp.neighbors, rp.neighbors) + pairs(pp.pools, rp.pools)
              + pairs(pp.upsamples, rp.upsamples))
    return {
        "batch_image_gap": _gap(prog.image, ref.image),
        "batch_pose_gap": max(_gap(prog.T_init, ref.T_init), _gap(prog.T_gt, ref.T_gt),
                              _gap(prog.intrinsics, ref.intrinsics)),
        "batch_corr_gap": max(_gap(a, b) for a, b in zip(prog.corr, ref.corr)),
        "batch_mesh_gap": max([_gap(a, b) for a, b in zip(prog.mesh, ref.mesh)]
                              + [_gap(prog.model_points, ref.model_points),
                                 _gap(prog.point_valid, ref.point_valid)]),
        "batch_pyramid_point_gap": max(_gap(a, b) for a, b in pairs(pp.points, rp.points)),
        "batch_pyramid_set_gap": (sum(_set_gap(a, b) for a, b in levels)
                                  + sum(float((a != b.to(a.device)).sum()) if a.shape == b.shape
                                        else float("inf") for a, b in pairs(pp.masks, rp.masks))),
    }


def worst(gaps: List[Dict[str, float]]) -> Dict[str, float]:
    """Each batch number's worst over the batches."""
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


def _follow(cfg, weights, batches, begin: Optional[Dict[str, Any]], first_grad: bool, device,
            control=None) -> Dict[str, Any]:
    """The reference's record of steps on `batches`, from the seed's weights
    (`begin` None) or from the state `begin` (as `train.follow`)."""
    from benchmark.reference.train.optim import OptimizerConfig, build_optimizer
    from benchmark.reference.train.step import make_train_step

    mods = build.side("reference")
    check.exact_f32()
    model = build.build_model(mods, cfg, device, f32=control is None)
    if control is not None:
        control(model)
    opt = build_optimizer(OptimizerConfig(), model)
    with torch.no_grad():
        if begin is None:
            build.load_weights(model, weights)
        else:
            build.load_weights(model, {n: t.to(device) for n, t in begin["params"].items()})
            names = [n for n, _ in model.named_parameters()]
            for key in ("m", "v"):
                for n, t in zip(names, getattr(opt, key)):
                    t.copy_(begin[key][n])
            opt.count.fill_(begin["count"])
    rec = train.record(make_train_step(model, opt), model, opt, batches, first_grad)
    del model, opt
    return rec


def training_numbers(cfg, traffic, weights, side, ref_batches, device) -> Dict[str, float]:
    """The training numbers of a side's records, the reference following
    each phase from the state that side started it from."""
    ranges = _ranges(traffic)
    ref = {"start": _follow(cfg, weights, [ref_batches[i] for i in ranges["start"]], None,
                            True, device),
           "replay": _follow(cfg, weights, [ref_batches[i] for i in ranges["replay"]],
                             side["start"]["end"], False, device)}
    return check.check_training(side, ref)


def flops_per_sample(cfg, weights, batch, device) -> float:
    """FlopCounterMode's count of one forward and backward of the reference
    on a batch, per sample."""
    from torch.utils.flop_counter import FlopCounterMode

    check.exact_f32()
    model = build.build_model(build.side("reference"), cfg, device, f32=True)
    build.load_weights(model, weights)
    with FlopCounterMode(display=False) as counter:
        model(batch, train=True)["loss"].backward()
    del model
    return counter.get_total_flops() / batch.image.shape[0]


def judge(ctx, got, trace: bool):
    """(the batch and training numbers, FLOPs per sample or None)."""
    cfg, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    try:
        frames = reference_frames(cfg, traffic, got["data_root"])
        ref = reference_batches(frames, sorted(got["kept"]), traffic["batch"], dev)
        numbers = worst([batch_gaps(got["kept"][i], ref[i]) for i in sorted(got["kept"])])
        numbers.update(training_numbers(cfg, traffic, got["weights"], got["record"], ref, dev))
        flops = flops_per_sample(cfg, got["weights"], ref[0], dev) if trace else None
    finally:
        shutil.rmtree(got["data_root"], ignore_errors=True)
    numbers["compared_batches"] = len(got["kept"])
    return numbers, flops


# ---- the control -----------------------------------------------------------

def control_numbers(cfg, traffic, seed: int, device) -> Dict[str, float]:
    """The cell's numbers with the control in the program's place: its
    batches the reference's with bf16 images, its steps the reference's
    with float8 inputs and weights in the bf16 convolutions
    (`control.fp8_control`), on the compared batches."""
    from benchmark.control import fp8_control

    if not cfg["mixed_precision"]:
        raise NotImplementedError("a float32 training configuration's control is TF32")
    cfg_path = write_data(cfg, traffic, seed, device)
    root = os.path.dirname(cfg_path)
    try:
        weights = gen.make_weights(build.build_model(build.side("reference"), cfg, "meta"),
                                   gen.seeds(seed)["weights"], device)
        ranges = _ranges(traffic)
        n = ranges["replay"].stop
        frames = reference_frames(cfg, traffic, root)
        ref = reference_batches(frames, range(n), traffic["batch"], device)
        low = reference_batches(frames, range(n), traffic["batch"], device,
                                image_dtype=torch.bfloat16)
        numbers = worst([batch_gaps(low[i], ref[i]) for i in range(n)])
        start = _follow(cfg, weights, [low[i] for i in ranges["start"]], None, True, device,
                        control=fp8_control)
        side = {"start": start,
                "replay": _follow(cfg, weights, [low[i] for i in ranges["replay"]],
                                  start["end"], False, device, control=fp8_control)}
        numbers.update(training_numbers(cfg, traffic, weights, side, ref, device))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return numbers


def main(argv=None) -> int:
    from benchmark.run import ROOT, _set_caches
    from benchmark.spec import load_spec

    p = argparse.ArgumentParser(description="the control's numbers of a train_data cell")
    p.add_argument("--config", required=True, help="a configuration's name in BENCHMARK.json")
    p.add_argument("--traffic", required=True, help="a traffic mix of the train_data kind")
    p.add_argument("--control_seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    _set_caches()
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    spec = load_spec(ROOT)
    cfg, traffic = spec.config(args.config), spec.traffic(args.traffic)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(cfg, traffic, seed, dev)
        line = json.dumps(dict(config=args.config, traffic=args.traffic, way="control",
                               seed=seed, numbers=numbers, seconds=time.perf_counter() - t0))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
