"""End-to-end learning check: overfit the synthetic object and require the
learned refinement to improve the noisy initial poses (port of
`rnnpose_tpu/tools/overfit_check.py`).

It exercises the descriptors, rendering, flow, similarity weighting, LM,
every loss, the optimizer and the eval metrics together: `--train_frames`
synthetic frames (seeds 0, 1, ...) train the port's `Trainer` for
`--steps` steps from random weights (seed 0), with the JAX tool's optimizer
(global-norm clip 10, then Adam at a constant `--lr`); then the eval
forward refines `--eval_frames` frames and ADD(refined) is compared with
ADD(init):

  * `--eval_mode heldout`: unseen frames (seeds 1000, 1001, ...);
  * `--eval_mode train_newinit`: the training frames with fresh init-pose
    noise, two draws per frame (seed 12345).

Returns (init ADD, refined ADD, losses) in metres; prints the
`OVERFIT_CHECK_RESULT {json}` line (init_add_mm, ref_add_mm, ratio,
loss_first50, loss_last50, eval_mode, steps, wall_s). `--remat` is accepted
and not implemented (the port stores activations).

Usage: python -m rnnpose_tpu_torch.tools.overfit_check [--steps 300]
           [--eval_mode heldout|train_newinit] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def clip_adam(model, lr: float, clip: float = 10.0):
    """`optax.chain(clip_by_global_norm(clip), adam(lr))`: the JAX tool's
    optimizer, as a `Trainer` optimizer: the device-side chain over every
    parameter with a constant lr, betas (0.9, 0.999) and no decay."""
    import torch

    from ..train.optim import DeviceAdam

    params = list(model.parameters())
    device = params[0].device
    lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
    b1_t = torch.tensor(0.9, dtype=torch.float32, device=device)
    return DeviceAdam(params, lr=lambda count: lr_t, beta1=lambda count: b1_t, b2=0.999,
                      eps=1e-8, weight_decay=0.0, clip=clip)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="overfit the synthetic object")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--train_frames", type=int, default=16)
    p.add_argument("--eval_frames", type=int, default=8)
    p.add_argument("--image_size", type=int, default=160)
    p.add_argument("--zoom", type=int, default=120)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lm_res", type=str, default="full")
    p.add_argument("--remat", choices=("default", "on", "off"), default="default",
                   help="accepted, not implemented: the port stores activations")
    p.add_argument("--num_verts", type=int, default=512)
    p.add_argument("--num_faces", type=int, default=1024)
    p.add_argument("--subdivisions", type=int, default=3)
    p.add_argument("--kp_layers", type=int, default=3)
    p.add_argument("--kp_dl", type=float, default=0.012)
    p.add_argument("--render_iters", type=int, default=3)
    p.add_argument("--gru_iters", type=int, default=4)
    p.add_argument("--eval_mode", choices=("heldout", "train_newinit"), default="heldout",
                   help="'heldout': unseen frames; 'train_newinit': the training frames "
                   "with fresh init-pose noise")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to run on the host)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..data.poses import sample_noisy_poses
    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
    from ..eval import metrics as M
    from ..models.refiner import RefinerConfig
    from ..models.rnnpose import RNNPose, RNNPoseConfig, init_random_
    from ..train.loop import Trainer
    from ..train.optim import OptimizerConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to run on the host")
    if args.remat != "default":
        print(f"--remat {args.remat}: not implemented (activations are stored)", flush=True)
    t_start = time.perf_counter()

    def syn(seed):
        return SyntheticConfig(image_size=args.image_size, num_verts=args.num_verts,
                               num_faces=args.num_faces, subdivisions=args.subdivisions,
                               kp_layers=args.kp_layers, kp_dl=args.kp_dl, seed=seed)

    t0 = time.perf_counter()
    train_set = [make_synthetic_inputs(syn(s), device=device, with_corr=True)
                 for s in range(args.train_frames)]
    if args.eval_mode == "heldout":
        eval_set = [make_synthetic_inputs(syn(1000 + s), device=device)
                    for s in range(args.eval_frames)]
    else:
        rs_init = np.random.RandomState(12345)
        eval_set = [b._replace(T_init=torch.from_numpy(
                        sample_noisy_poses(b.T_gt.cpu().numpy(), rs_init)).to(device))
                    for _ in range(2) for b in train_set[:args.eval_frames]]
    print(f"data built in {time.perf_counter() - t0:.0f}s", flush=True)

    kp = kpconv_config(syn(0))
    cfg = RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(zoom_crop_size=args.zoom, lm_res=args.lm_res,
                              render_iters=args.render_iters, gru_iters=args.gru_iters),
    )
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0)).to(device)
    trainer = Trainer(model, OptimizerConfig(), optimizer=clip_adam(model, args.lr))

    def eval_add():
        errs_init, errs_ref = [], []
        model.eval()
        with torch.no_grad():
            for b in eval_set:
                T = model(b)["Ti_pred"]
                for errs, Tp in ((errs_init, b.T_init), (errs_ref, T)):
                    e = M.add_error(Tp[:, :3, :3], Tp[:, :3, 3], b.T_gt[:, :3, :3],
                                    b.T_gt[:, :3, 3], b.model_points, b.point_valid)
                    errs.append(float(e.mean()))
        model.train()
        return float(np.mean(errs_init)), float(np.mean(errs_ref))

    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        m = trainer.run_step(train_set[i % len(train_set)])
        losses.append(float(m["loss"]))
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {np.mean(losses[-50:]):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)

    init_add, ref_add = eval_add()
    print(f"\n{args.eval_mode} ADD: init {init_add * 1000:.2f} mm -> refined "
          f"{ref_add * 1000:.2f} mm ({'IMPROVED' if ref_add < init_add else 'WORSE'})")
    print(f"loss: first50 {np.mean(losses[:50]):.4f} -> last50 {np.mean(losses[-50:]):.4f}")
    print("OVERFIT_CHECK_RESULT " + json.dumps({
        "init_add_mm": init_add * 1000.0,
        "ref_add_mm": ref_add * 1000.0,
        "ratio": ref_add / max(init_add, 1e-12),
        "loss_first50": float(np.mean(losses[:50])),
        "loss_last50": float(np.mean(losses[-50:])),
        "eval_mode": args.eval_mode,
        "steps": args.steps,
        "wall_s": time.perf_counter() - t_start,
    }), flush=True)
    return init_add, ref_add, losses


if __name__ == "__main__":
    main()
