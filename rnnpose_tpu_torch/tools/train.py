"""Training CLI (port of `rnnpose_tpu/tools/train.py`).

Usage:
  python -m rnnpose_tpu_torch.tools.train --synthetic --model_dir runs/x \\
      [--config_path cfg.yml] [--steps N] [--stop_after K] [--resume] \\
      [--seed S] [--display_step D] [--freeze "hybrid/desc2d"] \\
      [--pretrained_path ref.tckpt] [--device cuda]

One process trains on one device (`--device`, default `cuda`; the log names
it); without a visible card it raises unless `--device cpu` is given, so a
run never lands on the host by accident. `--synthetic` trains on the
synthetic fixture: `--syn_image_size` <= 64 picks the small one. The model
starts from random weights drawn from `--seed`, or from a reference-layout
state dict (`--pretrained_path`, loaded strictly). A `model_dir` that
already holds checkpoints is refused unless `--resume` is given, which
restores the model, the optimizer and the step from the newest checkpoint.
A checkpoint is written every `train_config.steps_per_eval` steps and at
the end; `--stop_after` leaves the loop after that step without changing
the schedule's total (a kill, for resume tests). `--steps`, `--stop_after`
and `--display_step` must be positive: another value exits with a usage
error before anything is written. Training on the LINEMOD data path with
periodic eval (ROADMAP Queue 1 item 3) and `--multihost` (item 4) raise
NotImplementedError; `--cost_analysis` and `--compile_cache_dir` are XLA
options, accepted and reported as ignored.
"""
from __future__ import annotations

import argparse
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
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cost_analysis", action="store_true",
                   help="XLA cost analysis: accepted, ignored")
    p.add_argument("--compile_cache_dir", type=str, default="",
                   help="XLA compile cache: accepted, ignored")
    return p.parse_args(argv)


def synthetic_setup(args, model_cfg, device, with_corr: bool = True):
    """The synthetic fixture batch (with its correspondence set unless
    `with_corr` is False) and the model config cut to it, as the JAX CLIs
    build them."""
    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs

    small = args.syn_image_size <= 64
    syn = SyntheticConfig(
        image_size=args.syn_image_size,
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
    import torch

    from ..config.defaults import build_model_config, build_optimizer_config, default_config
    from ..models.convert import load_reference_state_dict
    from ..models.rnnpose import RNNPose, init_random_
    from ..train import checkpoint as ckpt_lib
    from ..train.logging import ModelLog
    from ..train.loop import Trainer
    from ..utils.config_io import merge_cfg, save_cfg

    if args.multihost:
        raise NotImplementedError(
            "--multihost is not ported yet (ROADMAP Queue 1 item 4)")
    if not args.synthetic:
        raise NotImplementedError(
            "training on the LINEMOD data path, with periodic eval, is not ported yet "
            "(ROADMAP Queue 1 item 3); pass --synthetic")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is visible; pass --device cpu "
            "to train on the host")

    cfg = merge_cfg([args.config_path] if args.config_path else [], defaults=default_config())
    if args.steps is not None:
        cfg["train_config"]["steps"] = args.steps
    if not args.resume and os.path.exists(os.path.join(args.model_dir, "checkpoints.json")):
        raise RuntimeError(
            f"model_dir {args.model_dir} already contains checkpoints; pass --resume")
    os.makedirs(args.model_dir, exist_ok=True)
    save_cfg(cfg, os.path.join(args.model_dir, "config_resolved.yml"),
             source=args.config_path or "<defaults>")
    log = ModelLog(args.model_dir)
    log.log_text(f"training on {device}"
                 + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""), 0)
    for flag, given in (("--cost_analysis", args.cost_analysis),
                        ("--compile_cache_dir", bool(args.compile_cache_dir))):
        if given:
            log.log_text(f"{flag} is an XLA option: ignored", 0)

    opt_cfg = build_optimizer_config(cfg)
    if args.freeze:
        opt_cfg = dataclasses.replace(opt_cfg, freeze_patterns=tuple(args.freeze.split(",")))

    model_cfg = build_model_config(cfg)
    batch, model_cfg = synthetic_setup(args, model_cfg, device)

    def batches():
        while True:
            yield batch

    model = init_random_(RNNPose(model_cfg), torch.Generator().manual_seed(args.seed))
    if args.pretrained_path:
        load_reference_state_dict(model, args.pretrained_path)
    trainer = Trainer(model.to(device), opt_cfg)
    step = 0
    # Loaded on the host: load_state_dict puts each tensor where the trainer
    # keeps it (Adam's step counts stay on the host).
    restored = ckpt_lib.try_restore_latest(args.model_dir, map_location="cpu")
    if restored is not None:
        trainer.load_state_dict(restored)
        step = trainer.state.step
        log.log_text(f"restored checkpoint at step {step}", step)

    total = cfg["train_config"]["steps"]
    steps_per_eval = cfg["train_config"]["steps_per_eval"]
    batch_iter = batches()
    # The first batch is pulled before the loop (the data path reads its
    # shapes there) but not yet trained on: it is the next batch.
    pending = next(batch_iter)
    t_last = time.time()
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
        if args.stop_after is not None and step >= args.stop_after:
            log.log_text(f"stop_after {args.stop_after} reached", step)
            break
    log.log_text("training done", step)
    log.close()


if __name__ == "__main__":
    main()
