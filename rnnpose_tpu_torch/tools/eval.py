"""Evaluation CLI (port of `rnnpose_tpu/tools/eval.py`).

Loads a checkpoint, iterates the eval dataset with its PoseCNN/PVNet
initial poses, refines each class-grouped batch through
`models/engine.InferenceEngine` (`encode_3d` once per class) and reports
per-class ADD(-S) / Proj2D / 5cm5deg through the evaluators.

Usage:
  python -m rnnpose_tpu_torch.tools.eval --config_path cfg.yml \\
      --ckpt_path runs/x/rnnpose-200000 [--synthetic] [--device cuda]

The model runs on `--device` (default `cuda`; where no card is visible it
raises unless `--device cpu` is given). `--multihost` evaluates in N
processes, one per card, with the training CLI's launch flags
(`--coordinator_address`, `--num_processes`, `--process_id`,
`--dist_backend`, or torchrun's environment): process i reads frames i,
i + N, ... (of every `stride`-th frame), the summaries are gathered at the
end (`parallel/collectives.weighted_reduce_metrics`; a process without a
frame takes part with nothing), and rank 0 prints them and writes
`--dump_poses` in the frame order of one process. `fps` and `forward_ms`
are those of each process's own frames. `--ckpt_path` restores the model of
a port checkpoint (`train/checkpoint.py`), `--pretrained_path` a
reference-layout state dict; with neither the weights are random. The
iteration flags must be positive. The overall line holds the JAX CLI's keys
plus `forward_ms` (device time per frame, the forward bracketed by
synchronisations), and for a dataset `host_read_ms` (the CPU time of
reading and cropping a frame in the prefetch threads) and `host_collate_ms`
(per frame).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

from .train import add_launch_args, check_launch_args, launched, positive_int


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rnnpose_tpu_torch evaluator")
    p.add_argument("--config_path", type=str, default=None)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--pretrained_path", type=str, default=None,
                   help="a reference-layout state dict (loaded strictly)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--syn_image_size", type=int, default=160)
    p.add_argument("--syn_zoom", type=int, default=120)
    p.add_argument("--max_frames", type=positive_int, default=None)
    p.add_argument("--dump_poses", type=str, default=None,
                   help="directory for per-class pose dumps in the reference's layout "
                        "({cls}_pose_preds.npy)")
    p.add_argument("--icp", action="store_true",
                   help="ICP refinement against the depth cloud")
    p.add_argument("--icp_iters", type=positive_int, default=10)
    p.add_argument("--icp_corr_dist", type=float, default=0.02)
    p.add_argument("--icp_points", type=int, default=1024,
                   help="scene-cloud budget (padded static shape)")
    p.add_argument("--eval_batch", type=positive_int, default=1,
                   help="frames per forward (one class per batch; the tail padded)")
    p.add_argument("--evaluator", choices=("auto", "linemod", "ycb"), default="auto",
                   help="metric protocol: 'linemod' = ADD(-S)@0.1/0.05/0.02d + Proj2D + "
                        "5cm5deg; 'ycb' adds the PoseCNN AUC metrics and the YCB "
                        "symmetric set; 'auto' picks ycb for BOP-YCB class names")
    p.add_argument("--desc_tail_res", choices=("full", "half"), default=None,
                   help="override the eval 2D-descriptor tail resolution (default: the "
                        "serving preset 'half'; --parity restores 'full')")
    p.add_argument("--render_iters", type=positive_int, default=None,
                   help="override the outer render-iteration budget (default 3)")
    p.add_argument("--gru_iters", type=positive_int, default=None,
                   help="override the inner GRU/LM iteration budget (default 4)")
    p.add_argument("--parity", action="store_true",
                   help="the reference-exact operating mode (apply_parity_preset)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to evaluate on the host)")
    p.add_argument("--plain_raster", action="store_true",
                   help="run the plain PyTorch z-buffer sweeps instead of the CUDA kernels "
                        "(a check of the kernels; same results)")
    add_launch_args(p)
    return check_launch_args(p, p.parse_args(argv))


def make_frame_stream(dataset, eval_batch=1, max_frames=None, device="cpu", host_times=None,
                      stride=1, process_index=0, process_count=1):
    """Class-grouped, padded eval chunks: ordered host prefetch over the
    dataset (every `stride`-th frame, at most `max_frames` of them; of
    those, process `process_index` of `process_count` reads every
    `process_count`-th from its index on), per-class grouping to
    `eval_batch`, a tail chunk padded by repeating its last frame, collated
    on `device`.

    Yields (inputs, cls, diameter_m, model_points, point_valid, raws), `raws`
    the chunk's real sample dicts (padding excluded), each with its dataset
    index under "frame_index". With a `host_times`
    dict, adds the CPU seconds the prefetch threads spent reading and
    cropping, the seconds spent collating, and the frames to its "read_s",
    "collate_s" and "frames".
    """
    import numpy as np

    from ..data.linemod import collate_samples
    from ..data.linemod_config import diameter_m
    from ..data.loader import prefetch_map

    times = host_times if host_times is not None else {}
    for key in ("read_s", "collate_s", "frames"):
        times.setdefault(key, 0)
    lock = threading.Lock()
    diam_cache = {}

    def diameter(cls, assets):
        """The LINEMOD table; else the exact largest pairwise distance of
        the model points."""
        if cls not in diam_cache:
            try:
                diam_cache[cls] = diameter_m(cls)
            except KeyError:
                pts = assets.model_points[assets.point_valid > 0]
                d2 = ((pts[None] - pts[:, None]) ** 2).sum(-1)
                diam_cache[cls] = float(np.sqrt(d2.max()))
        return diam_cache[cls]

    def fetch(i):
        t0 = time.thread_time()  # this thread's CPU time: no wait for the GIL
        s = dataset[i]
        with lock:
            times["read_s"] += time.thread_time() - t0
        s["frame_index"] = i
        return s

    def emit(chunk):
        full = chunk + [chunk[-1]] * (eval_batch - len(chunk))
        cls = full[0]["class_name"]
        assets = dataset.class_assets(cls)
        t0 = time.perf_counter()
        inputs = collate_samples(full, device=device)
        times["collate_s"] += time.perf_counter() - t0
        times["frames"] += len(chunk)
        return inputs, cls, diameter(cls, assets), assets.model_points, assets.point_valid, chunk

    def gen():
        step = max(stride, 1)
        n = min(len(dataset), max_frames * step) if max_frames else len(dataset)
        buffers = {}
        # Process p takes every N-th of the strided frames from the p-th on:
        # together the one-process set. (The JAX package's range(p, n,
        # stride * N) reads other frames, and more than max_frames, when
        # stride > 1.)
        for s in prefetch_map(range(process_index * step, n, step * process_count), fetch):
            cls = s["class_name"]
            buffers.setdefault(cls, []).append(s)
            if len(buffers[cls]) == eval_batch:
                yield emit(buffers.pop(cls))
        for cls in list(buffers):
            yield emit(buffers.pop(cls))

    return gen()


class EvalRunner:
    """The evaluation loop over `InferenceEngine`: `encode_3d` once per class,
    then the forward per chunk, the padding dropped, the evaluators fed.

    Frames are (inputs, cls, diameter, model_points, point_valid, raws), as
    `make_frame_stream` yields them; `raws`, the chunk's real sample dicts
    (the padding drop, original-camera Proj2D and the ICP depth clouds), may
    be None (a synthetic batch).
    """

    def __init__(self, model, *, icp=False, icp_iters=10, icp_corr_dist=0.02, icp_points=1024,
                 evaluator="auto"):
        from ..models.engine import InferenceEngine

        self.engine = InferenceEngine(model)
        self.icp = icp
        self.icp_iters = icp_iters
        self.icp_corr_dist = icp_corr_dist
        self.icp_points = icp_points
        self.evaluator = evaluator

    def _make_evaluator(self, cls, diameter, model_points, point_valid, device):
        from ..data.ycb import BOP_YCB_CLASSES
        from ..eval.evaluator import PoseEvaluator, YCBEvaluator

        use_ycb = self.evaluator == "ycb" or (self.evaluator == "auto"
                                              and cls in BOP_YCB_CLASSES)
        ev_cls = YCBEvaluator if use_ycb else PoseEvaluator
        pts = model_points[point_valid > 0] if point_valid is not None else model_points
        return ev_cls(cls, diameter, pts, icp_refine=self.icp, icp_iters=self.icp_iters,
                      icp_max_corr_dist=self.icp_corr_dist, device=device)

    def _scene_clouds(self, raws):
        """The depth-lifted scene cloud of each frame, cut or zero-padded to
        `icp_points`: dict(scene_points (B, M, 3), scene_valid (B, M))."""
        import numpy as np

        from ..data import preprocess as prep

        m = self.icp_points
        clouds, valids = [], []
        for r in raws:
            K4 = np.asarray(r["intrinsics"])
            K33 = np.asarray([[K4[0], 0, K4[2]], [0, K4[1], K4[3]], [0, 0, 1]], np.float32)
            pts_cam, _ = prep.mask_depth_to_points(r["depth"], K33)
            if len(pts_cam) > m:
                pts_cam = pts_cam[np.linspace(0, len(pts_cam) - 1, m).astype(np.int64)]
            pad = m - len(pts_cam)
            valids.append(np.concatenate([np.ones(len(pts_cam)), np.zeros(pad)]).astype(
                np.float32))
            clouds.append(np.concatenate([pts_cam, np.zeros((pad, 3), np.float32)]))
        return dict(scene_points=np.stack(clouds), scene_valid=np.stack(valids))

    def run(self, frames, max_frames=None, progress=None, collect_poses=False):
        """Returns (per-class summaries, the seq_len-weighted overall with
        fps and forward_ms, {cls: poses} if collect_poses else None).

        Under a process group every rank calls it, a rank without frames
        too: the summaries and poses are those of every rank's frames (the
        poses in frame-index order), the same on every rank; fps and
        forward_ms are this rank's."""
        import numpy as np
        import torch

        from ..parallel.collectives import weighted_reduce_metrics
        from ..parallel.mesh import all_gather_object, process_count

        evaluators, poses_out, order = {}, {}, {}
        t_total, n_frames = 0.0, 0
        for item in frames:
            if max_frames is not None and n_frames >= max_frames:
                break
            inputs, cls, diameter, model_points, point_valid, raws = item
            dev = inputs.image.device
            if cls not in evaluators:
                evaluators[cls] = self._make_evaluator(cls, diameter, model_points,
                                                       point_valid, dev)
            # The class's 3D features before the clock starts, as the JAX
            # runner caches them before its timed forward.
            self.engine.class_features(cls, inputs.pyramid)
            sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
            sync()
            t0 = time.perf_counter()
            T_pred = self.engine.refine(cls, inputs)["Ti_pred"]
            sync()
            t_total += time.perf_counter() - t0
            n_real = len(raws) if raws is not None else inputs.image.shape[0]
            n_frames += n_real
            T_np = T_pred.detach().cpu().numpy()[:n_real]
            T_gt_np = inputs.T_gt.cpu().numpy()[:n_real]
            scene_kw = {}
            if self.icp:
                if raws is None:
                    raise SystemExit("--icp needs real depth frames; it cannot be combined "
                                     "with --synthetic (no raw depth on synthetic inputs).")
                scene_kw = self._scene_clouds(raws)
            # Proj2D thresholds in original-camera pixels: the crop
            # intrinsics would rescale them.
            if raws is not None and all("orig_intrinsics" in r for r in raws):
                K_eval = np.stack([np.asarray(r["orig_intrinsics"]) for r in raws])
            else:
                K_eval = inputs.intrinsics.cpu().numpy()[:n_real]
            evaluators[cls].evaluate(T_np, T_gt_np, K_eval, **scene_kw)
            if collect_poses:
                poses_out.setdefault(cls, []).append(T_np)
                order.setdefault(cls, []).extend(
                    [r["frame_index"] for r in raws] if raws is not None
                    else range(n_frames - n_real, n_frames))
            if progress is not None:
                progress.update(n_frames)
        results = {cls: ev.summarize() for cls, ev in evaluators.items()}
        overall = weighted_reduce_metrics(list(results.values()))
        overall["fps"] = n_frames / max(t_total, 1e-9)
        overall["forward_ms"] = 1e3 * t_total / max(n_frames, 1)
        poses = ({c: np.concatenate(p) for c, p in poses_out.items()}
                 if collect_poses else None)
        if process_count() > 1:
            # The same collectives in the same order on every rank.
            classes = sorted({c for names in all_gather_object(sorted(results))
                              for c in names})
            results = {c: weighted_reduce_metrics([results[c]] if c in results else [])
                       for c in classes}
            if collect_poses:
                poses = _merge_poses(all_gather_object(
                    {c: (order[c], poses[c]) for c in poses}))
        return results, overall, poses


def evaluate_frames(model, frames, max_frames=None):
    """One-shot `EvalRunner` over frames as `make_frame_stream` yields them
    (the JAX package's `evaluate_frames(model, params, frames, ...)`; the
    port's model holds its weights). Returns (per-class summaries, overall)."""
    results, overall, _ = EvalRunner(model).run(frames, max_frames=max_frames)
    return results, overall


def _merge_poses(per_rank):
    """{cls: poses} from every rank's {cls: (frame indices, poses)}, each
    class's rows in frame-index order."""
    import numpy as np

    merged = {}
    for part in per_rank:
        for cls, (idx, p) in part.items():
            merged.setdefault(cls, []).append((np.asarray(idx), p))
    out = {}
    for cls, parts in merged.items():
        idx = np.concatenate([i for i, _ in parts])
        out[cls] = np.concatenate([p for _, p in parts])[np.argsort(idx, kind="stable")]
    return out


def main(argv=None):
    args = parse_args(argv)
    with launched(args) as device:
        return _evaluate(args, device)


def _evaluate(args, device):
    import dataclasses
    import itertools

    import numpy as np
    import torch

    from ..config.defaults import build_dataset, build_model_config, default_config
    from ..models.convert import load_reference_state_dict
    from ..models.rnnpose import RNNPose, apply_parity_preset, init_random_
    from ..parallel.mesh import all_gather_object, process_count, process_index
    from ..train import checkpoint as ckpt_lib
    from ..utils.config_io import merge_cfg
    from ..utils.progress import ProgressBar
    from .train import synthetic_setup

    pid, nproc = process_index(), process_count()
    lead = pid == 0
    cfg = merge_cfg([args.config_path] if args.config_path else [], defaults=default_config())
    model_cfg = build_model_config(cfg)

    host_times = {}
    if args.synthetic:
        inputs, model_cfg = synthetic_setup(args, model_cfg, device, with_corr=False)
        frames = [(inputs, "synthetic", 0.12, inputs.model_points[0].cpu().numpy(),
                   inputs.point_valid[0].cpu().numpy(), None)][pid::nproc]
    else:
        dataset = build_dataset(cfg, model_cfg.desc_kp, is_train=False)
        frames = make_frame_stream(dataset, eval_batch=args.eval_batch,
                                   max_frames=args.max_frames, device=device,
                                   host_times=host_times, process_index=pid,
                                   process_count=nproc)

    if args.parity:
        model_cfg = apply_parity_preset(model_cfg)
    if args.desc_tail_res is not None:
        model_cfg = dataclasses.replace(model_cfg, desc2d_eval_tail_res=args.desc_tail_res)
    ref = model_cfg.refiner
    model_cfg = dataclasses.replace(model_cfg, refiner=dataclasses.replace(
        ref,
        render_iters=ref.render_iters if args.render_iters is None else args.render_iters,
        gru_iters=ref.gru_iters if args.gru_iters is None else args.gru_iters,
    ))

    model = init_random_(RNNPose(model_cfg, plain_raster=args.plain_raster),
                         torch.Generator().manual_seed(0))
    if args.ckpt_path:
        model.load_state_dict(ckpt_lib.restore_checkpoint(args.ckpt_path,
                                                          map_location="cpu")["model"])
    if args.pretrained_path:
        load_reference_state_dict(model, args.pretrained_path)
    model = model.to(device).eval()
    # The operating mode, stated before the metrics.
    if lead:
        print("eval operating mode: "
              f"desc_tail_res={model_cfg.desc2d_eval_tail_res} "
              f"parity={'on' if args.parity else 'off'} "
              f"render_iters={model_cfg.refiner.render_iters} "
              f"gru_iters={model_cfg.refiner.gru_iters} device={device}"
              + (f" processes={nproc} ({args.dist_backend})" if args.multihost else ""),
              flush=True)

    frames = iter(frames)
    first = next(frames, None)
    # Empty only when no rank has a frame; a rank without one takes part.
    if not any(all_gather_object(first is not None)):
        raise SystemExit("eval dataset is empty")
    runner = EvalRunner(model, icp=args.icp, icp_iters=args.icp_iters,
                        icp_corr_dist=args.icp_corr_dist, icp_points=args.icp_points,
                        evaluator=args.evaluator)
    results, overall, poses_out = runner.run(
        itertools.chain([] if first is None else [first], frames),
        progress=ProgressBar() if lead else None, collect_poses=bool(args.dump_poses))
    if host_times.get("frames"):
        overall["host_read_ms"] = 1e3 * host_times["read_s"] / host_times["frames"]
        overall["host_collate_ms"] = 1e3 * host_times["collate_s"] / host_times["frames"]

    if not lead:
        return overall
    for cls, summary in results.items():
        print(f"\n=== {cls} ===")
        for k, v in summary.items():
            print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    print("\n=== overall (seq_len weighted) ===")
    print(json.dumps({k: round(float(v), 5) for k, v in overall.items()}))
    if args.dump_poses and poses_out:
        os.makedirs(args.dump_poses, exist_ok=True)
        for cls, parr in poses_out.items():
            np.save(os.path.join(args.dump_poses, f"{cls}_pose_preds.npy"), parr)
    return overall


if __name__ == "__main__":
    main()
