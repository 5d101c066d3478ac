"""Training CLI (port of `rnnpose_tpu/tools/train.py`).

Usage:
  python -m rnnpose_tpu_torch.tools.train --config_path cfg.yml --model_dir runs/x \\
      [--steps N] [--stop_after K] [--resume] [--seed S] [--display_step D] \\
      [--loader_threads T] [--eval_frames F] [--eval_batch B] \\
      [--freeze "hybrid/desc2d"] [--pretrained_path ref.tckpt] [--device cuda]
  python -m rnnpose_tpu_torch.tools.train --synthetic --model_dir runs/x [...]
  torchrun --nproc_per_node N -m rnnpose_tpu_torch.tools.train --multihost [...]
  python -m rnnpose_tpu_torch.tools.train --multihost --coordinator_address host:port \
      --num_processes N --process_id I [--dist_backend nccl|gloo] [...]

One process trains on one device (`--device`, default `cuda`; the log names
it); without a visible card it raises unless `--device cpu` is given, so a
run never lands on the host by accident.

`--multihost` trains data-parallel over N processes, one per card: the
process group forms from the flags (rank 0 listens at the coordinator
address) or from torchrun's environment, over `--dist_backend` (default
nccl for a cuda device, gloo for cpu; nccl with cpu is refused, and two
ranks on one card under nccl fail with NCCL's own error). A rank's device is
`cuda:<LOCAL_RANK>` (torchrun), `cuda:<process_id>` (the flags) or the
indexed `--device`. `train_input_reader.batch_size` is the batch of one
process, so a step takes N x batch_size samples: process i reads shard i
of the sampler, and the sample at its k-th stream position draws its
augmentation from position k * N + i, disjoint from every other process's.
Every rank starts from rank 0's parameters (broadcast after the restore),
and the step averages the gradients and loss terms over the ranks before
its norm (`train/loop.py`). Only rank 0 writes the config, the logs and the
checkpoints; every rank waits for a checkpoint before going on and restores
from the same `model_dir`, which must be storage every rank sees. The
periodic eval strides its frames over the ranks and gathers the summaries.

Data: the config's `train_input_reader` dataset (LINEMOD-format `.info`
files; synthetic frames over VOC backgrounds when `voc_root` is set).
`GivenIterationSampler` orders the frames for `train_config.steps` batches;
the sample at stream position p draws its augmentation from (seed, p)
(`LinemodSynRealDataset.sample_at`), so the batches do not depend on
`--loader_threads` (a `PrefetchLoader` of that many threads; 0 reads them
synchronously) and a resumed run reads the same batches as an uninterrupted
one. Degenerate frames (too few correspondences) are skipped. `--synthetic`
trains on the synthetic fixture instead: `--syn_image_size` <= 64 picks the
small one.

The model starts from random weights drawn from `--seed`, or from a
reference checkpoint (`--pretrained_path`: a full-model `.tckpt` or a bare
`superpoint_v1.pth`, `img_fea_enc.pth` or `gru_update.pth`, loaded
non-strictly by `models/convert.load_pretrained`). A
`model_dir` that already holds checkpoints is refused unless `--resume` is
given, which restores the model, the optimizer and the step from the
newest checkpoint and fast-forwards the sampler to it. A checkpoint is
written every `train_config.steps_per_eval` steps and at the end; after
each, when the config names eval `info_paths` and `--eval_frames` > 0, a
periodic eval refines every `len // eval_frames`-th eval frame (at most
`--eval_frames`, `--eval_batch` per forward) and logs `eval/<key>` for the
evaluator's overall keys and `eval/params_l1` (the sum of |p| over the
parameters); it changes no training state. `--stop_after` leaves the loop
after that step without changing the schedule's total (a kill, for resume
tests). `--steps`, `--stop_after`, `--display_step` and `--eval_batch` must
be positive, `--loader_threads` and `--eval_frames` non-negative: another
value exits with a usage error, and an empty training dataset with
ValueError, before anything is written; so do `--num_processes` <= 0, a
`--process_id` outside the world, and a launch flag without `--multihost`.
`--cost_analysis` and `--compile_cache_dir` are XLA options, accepted and
reported as ignored.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time


def positive_int(text: str) -> int:
    """argparse type of the iteration flags: an int > 0 (the JAX CLIs take
    0 as "unset" by truthiness; the port refuses it)."""
    value = int(text)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive int, got {text}")
    return value


def non_negative_int(text: str) -> int:
    """argparse type of the counts where 0 has a meaning: an int >= 0."""
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be a non-negative int, got {text}")
    return value


def add_launch_args(p: argparse.ArgumentParser):
    """The multi-process launch flags of the training and eval CLIs."""
    p.add_argument("--multihost", action="store_true",
                   help="join a process group first: one process per card")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port where rank 0 listens; without it, torchrun's environment")
    p.add_argument("--num_processes", type=positive_int, default=None)
    p.add_argument("--process_id", type=non_negative_int, default=None)
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="collective backend (default: nccl for a cuda device, gloo for cpu)")


def check_launch_args(p: argparse.ArgumentParser, args):
    """Refuse launch flags that do not fit together (a usage error), and
    fill in the backend's default."""
    given = [f for f in ("coordinator_address", "num_processes", "process_id", "dist_backend")
             if getattr(args, f) is not None]
    if given and not args.multihost:
        p.error(f"--{given[0]} needs --multihost")
    if args.coordinator_address and (args.num_processes is None or args.process_id is None):
        p.error("--coordinator_address needs --num_processes and --process_id")
    if (args.process_id is not None and args.num_processes is not None
            and args.process_id >= args.num_processes):
        p.error(f"--process_id {args.process_id} is outside a world of "
                f"{args.num_processes} processes")
    cuda = args.device.split(":")[0] == "cuda"
    if args.dist_backend is None:
        args.dist_backend = "nccl" if cuda else "gloo"
    elif args.dist_backend == "nccl" and not cuda:
        p.error(f"--dist_backend nccl needs a cuda device, got --device {args.device}")
    return args


@contextlib.contextmanager
def launched(args):
    """This process's device for the run: `--device`, or under
    `--multihost` the rank's device in the process group it joins
    (`parallel/mesh.init_distributed`) and leaves at the end. Without a
    visible card a cuda device raises."""
    import torch
    import torch.distributed as dist

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to run on the host")
    if not args.multihost:
        yield torch.device(args.device)
        return
    from ..parallel.mesh import init_distributed

    device = init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                              backend=args.dist_backend, device=args.device)
    try:
        yield device
    finally:
        dist.destroy_process_group()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rnnpose_tpu_torch trainer")
    p.add_argument("--config_path", type=str, default=None)
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--freeze", type=str, default="",
                   help="comma-separated regexes over flax parameter paths")
    p.add_argument("--steps", type=positive_int, default=None, help="override total steps")
    p.add_argument("--stop_after", type=positive_int, default=None,
                   help="leave the loop after this step without changing the "
                   "schedule's total")
    p.add_argument("--display_step", type=positive_int, default=50)
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic fixture")
    p.add_argument("--syn_image_size", type=int, default=160)
    p.add_argument("--syn_zoom", type=int, default=120)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to train on the host)")
    p.add_argument("--loader_threads", type=non_negative_int, default=4,
                   help="host prefetch worker threads (0 = synchronous)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_frames", type=non_negative_int, default=200,
                   help="frames per periodic in-training eval (0 disables)")
    p.add_argument("--eval_batch", type=positive_int, default=1,
                   help="frames per periodic-eval forward")
    p.add_argument("--cost_analysis", action="store_true",
                   help="XLA cost analysis: accepted, ignored")
    p.add_argument("--compile_cache_dir", type=str, default="",
                   help="XLA compile cache: accepted, ignored")
    add_launch_args(p)
    return check_launch_args(p, p.parse_args(argv))


def synthetic_setup(args, model_cfg, device, with_corr: bool = True, batch_size: int = 1):
    """The synthetic fixture batch of `batch_size` items (with its
    correspondence set unless `with_corr` is False) and the model config cut
    to it, as the JAX CLIs build them."""
    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs

    small = args.syn_image_size <= 64
    syn = SyntheticConfig(
        image_size=args.syn_image_size,
        batch_size=batch_size,
        num_verts=128 if small else 512,
        num_faces=256 if small else 1024,
        subdivisions=2 if small else 3,
        num_corr=64 if small else 256,
        kp_layers=2 if small else 3,
        kp_dl=0.02 if small else 0.012,
        fx=100.0 if small else 572.4114,
        fy=100.0 if small else 573.57043,
    )
    inputs = make_synthetic_inputs(syn, device=device, with_corr=with_corr)
    kp = kpconv_config(syn)
    rc = model_cfg.refiner
    model_cfg = dataclasses.replace(
        model_cfg,
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=dataclasses.replace(
            rc,
            zoom_crop_size=args.syn_zoom,
            raster_chunk=64 if small else 128,
            render_iters=2 if small else rc.render_iters,
            gru_iters=2 if small else rc.gru_iters,
            corr_levels=2 if small else rc.corr_levels,
        ),
    )
    return inputs, model_cfg


def main(argv=None):
    args = parse_args(argv)
    with launched(args) as device:
        _train(args, device)


def _train(args, device):
    import torch

    from ..config.defaults import build_model_config, build_optimizer_config, default_config
    from ..models.convert import load_pretrained
    from ..models.rnnpose import RNNPose, init_random_
    from ..parallel import mesh
    from ..train import checkpoint as ckpt_lib
    from ..train.logging import ModelLog
    from ..train.loop import Trainer
    from ..utils.config_io import merge_cfg, save_cfg

    pid, nproc = mesh.process_index(), mesh.process_count()
    lead = pid == 0
    cfg = merge_cfg([args.config_path] if args.config_path else [], defaults=default_config())
    if args.steps is not None:
        cfg["train_config"]["steps"] = args.steps
    # Rank 0 decides for every rank, so all of them raise together.
    if not args.resume and mesh.broadcast_object(
            lead and os.path.exists(os.path.join(args.model_dir, "checkpoints.json"))):
        raise RuntimeError(
            f"model_dir {args.model_dir} already contains checkpoints; pass --resume")
    model_cfg = build_model_config(cfg)
    if not args.synthetic:
        from ..config.defaults import build_dataset

        dataset = build_dataset(cfg, model_cfg.desc_kp, is_train=True)
        if len(dataset) == 0:
            raise ValueError(
                "the training dataset holds no frame: give train_input_reader's info_paths "
                "in --config_path, or pass --synthetic")
    if lead:
        os.makedirs(args.model_dir, exist_ok=True)
        save_cfg(cfg, os.path.join(args.model_dir, "config_resolved.yml"),
                 source=args.config_path or "<defaults>")
    log = ModelLog(args.model_dir)
    log.log_text(f"training on {device}"
                 + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                 + (f", {nproc} processes over {args.dist_backend}" if args.multihost else ""),
                 0)
    for flag, given in (("--cost_analysis", args.cost_analysis),
                        ("--compile_cache_dir", bool(args.compile_cache_dir))):
        if given:
            log.log_text(f"{flag} is an XLA option: ignored", 0)

    opt_cfg = build_optimizer_config(cfg)
    if args.freeze:
        opt_cfg = dataclasses.replace(opt_cfg, freeze_patterns=tuple(args.freeze.split(",")))

    if args.synthetic:
        # The same batch on every rank.
        batch, model_cfg = synthetic_setup(args, model_cfg, device)

        def batches(last_iter=-1):
            while True:
                yield batch
    else:
        def batches(last_iter=-1):
            return dataset_batches(dataset, cfg, last_iter, args.loader_threads, device,
                                   shard_id=pid, num_shards=nproc)

    model = init_random_(RNNPose(model_cfg), torch.Generator().manual_seed(args.seed))
    if args.pretrained_path:
        # Non-strict, as the JAX package's CLI: a full-model checkpoint or a
        # bare sub-network file; the unmatched keys are printed.
        load_pretrained(model, args.pretrained_path)
    trainer = Trainer(model.to(device), opt_cfg)
    step = 0
    loader = batches()
    batch_iter = iter(loader)
    # The first batch is pulled before the loop but not yet trained on: it
    # is the next batch (see `pending` below).
    first = next(batch_iter)
    # Loaded on the host: load_state_dict puts each tensor where the
    # trainer keeps it (Adam's step counts stay on the host).
    restored = ckpt_lib.try_restore_latest(args.model_dir, map_location="cpu")
    if restored is not None:
        trainer.load_state_dict(restored)
        step = trainer.state.step
        log.log_text(f"restored checkpoint at step {step}", step)
        if not args.synthetic:
            # The batch stream again, fast-forwarded to the restored step.
            getattr(loader, "close", lambda: None)()
            loader = batches(last_iter=step - 1)
            batch_iter = iter(loader)
            first = next(batch_iter)
    mesh.replicate_params(model)
    mesh.barrier()

    periodic_eval = None
    if not args.synthetic and args.eval_frames > 0:
        if cfg["eval_input_reader"]["dataset"]["kwargs"].get("info_paths"):
            periodic_eval = make_periodic_eval(cfg, model_cfg, model, args, device)

    total = cfg["train_config"]["steps"]
    steps_per_eval = cfg["train_config"]["steps_per_eval"]
    t_last = time.time()
    # `first` is the next batch: consuming `next(...)` instead after a
    # restore would drop one batch and break resume equality.
    pending = first
    while step < total:
        if pending is not None:
            b, pending = pending, None
        else:
            try:
                b = next(batch_iter)
            except StopIteration:
                break
        metrics = trainer.run_step(b)
        step = trainer.state.step
        if step % args.display_step == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_sec"] = args.display_step / max(time.time() - t_last, 1e-9)
            t_last = time.time()
            log.log_metrics(m, step)
        if step % steps_per_eval == 0 or step == total:
            ckpt_lib.save_checkpoint(args.model_dir, trainer.state_dict(), step)
            log.log_text(f"checkpoint saved at step {step}", step)
            if periodic_eval is not None:
                log.log_metrics(periodic_eval(), step)
        if args.stop_after is not None and step >= args.stop_after:
            log.log_text(f"stop_after {args.stop_after} reached", step)
            break
    log.log_text("training done", step)
    getattr(loader, "close", lambda: None)()
    log.close()


def dataset_batches(dataset, cfg, last_iter: int, loader_threads: int, device,
                    shard_id: int = 0, num_shards: int = 1):
    """The training batch stream of a dataset: shard `shard_id` of
    `num_shards` of `GivenIterationSampler` over `train_config.steps`
    batches fast-forwarded past `last_iter`, the sample at the shard's k-th
    stream position read with `dataset.sample_at(idx, k * num_shards +
    shard_id)` (the shards' augmentation streams are disjoint), degenerate
    frames skipped, `batch_size` samples collated on `device`. A
    `PrefetchLoader` of `loader_threads` threads, or a generator that reads
    synchronously when it is 0; both yield the same batches."""
    from ..data.linemod import collate_samples
    from ..data.preprocess import TooFewCorrespondences
    from ..data.samplers import GivenIterationSampler

    bs = cfg["train_input_reader"]["batch_size"]
    sampler = GivenIterationSampler(len(dataset), total_iter=cfg["train_config"]["steps"],
                                    batch_size=bs, shard_id=shard_id, num_shards=num_shards,
                                    last_iter=last_iter)
    start = (last_iter + 1) * bs
    indexed = (((start + k) * num_shards + shard_id, idx) for k, idx in enumerate(sampler))

    def fetch(pos_idx):
        pos, idx = pos_idx
        return dataset.sample_at(idx, pos)

    def collate(samples):
        return collate_samples(samples, device=device)

    if loader_threads > 0:
        from ..data.loader import PrefetchLoader

        return PrefetchLoader(indexed, fetch, bs, collate, num_threads=loader_threads,
                              skip_exc=TooFewCorrespondences)

    def sync_gen():
        it = iter(indexed)
        while True:
            samples = []
            while len(samples) < bs:
                try:
                    samples.append(fetch(next(it)))
                except TooFewCorrespondences:
                    continue
                except StopIteration:
                    return
            yield collate(samples)

    return sync_gen()


def make_periodic_eval(cfg, model_cfg, model, args, device):
    """A function that evaluates `model` on the config's eval dataset and
    returns the metrics to log: every `len // eval_frames`-th frame (at most
    `eval_frames`), `eval_batch` per forward, through one persistent
    `EvalRunner`; under a process group every rank calls it, each takes
    every N-th of those frames and the summaries are gathered. It runs
    without gradients, in eval mode, and hands the model back in train
    mode; it reads no training state."""
    import torch

    from ..config.defaults import build_dataset
    from ..parallel.mesh import process_count, process_index
    from .eval import EvalRunner, make_frame_stream

    eval_ds = build_dataset(cfg, model_cfg.desc_kp, is_train=False)
    runner = EvalRunner(model)
    stride = max(len(eval_ds) // args.eval_frames, 1)

    def run():
        # The class features of the previous eval belong to older weights.
        runner.engine.evict()
        model.eval()
        try:
            with torch.no_grad():
                frames = make_frame_stream(eval_ds, eval_batch=args.eval_batch,
                                           max_frames=args.eval_frames, stride=stride,
                                           device=device, process_index=process_index(),
                                           process_count=process_count())
                _, overall, _ = runner.run(frames, max_frames=args.eval_frames)
                params_l1 = float(sum(p.detach().abs().sum() for p in model.parameters()))
        finally:
            model.train()
        return {**{f"eval/{k}": v for k, v in overall.items()}, "eval/params_l1": params_l1}

    return run


if __name__ == "__main__":
    main()
