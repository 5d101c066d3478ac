"""Accuracy against the iteration budget (port of
`rnnpose_tpu/tools/budget_frontier.py`).

For each point of a grid over (render_iters x gru_iters), the reference's
RENDER_ITER_COUNT x ITER_COUNT budget, it records the accuracy of a
trained checkpoint on its eval split through the port's eval CLI
(`tools/eval.main`: ADD(-S) thresholds, mean distances, rotation and
translation errors) and, unless `--skip_fps`, the fps at B=1 and B=8 at
that budget by `tools/measure_fps` (bench.py's chained protocol, on its
synthetic operating point: `--fps_scene bench`, or `tiny` for a quick run
on the CPU), with `FlopCounterMode`'s GFLOPs per frame at B=1.

Usage:
  python -m rnnpose_tpu_torch.tools.budget_frontier --config_path cfg.yml \\
      --ckpt_path runs/x/rnnpose-20000 [--grid 3x4,3x3,3x2,2x4,2x3,2x2,1x4]
      [--max_frames 64] [--eval_batch 1] [--skip_fps] [--out frontier.json]
      [--device cuda|cpu]

Output: one `FRONTIER {json}` line per grid point, a markdown table, and
with `--out` the JSON list of the rows. Returns the rows.
"""
from __future__ import annotations

import argparse
import json

from .measure_fps import SCENES
from .train import positive_int


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="accuracy and fps against the iteration budget")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--grid", type=str, default="3x4,3x3,3x2,2x4,2x3,2x2,1x4",
                   help="comma-separated RxG points (R=render_iters, G=gru_iters); 3x4 is "
                   "the reference budget")
    p.add_argument("--max_frames", type=positive_int, default=None)
    p.add_argument("--eval_batch", type=positive_int, default=1)
    p.add_argument("--desc_tail_res", choices=("full", "half"), default=None)
    p.add_argument("--skip_fps", action="store_true", help="accuracy only")
    p.add_argument("--fps_scene", choices=sorted(SCENES), default="bench")
    p.add_argument("--fps_frames", type=positive_int, default=40,
                   help="frames per timed chain (the protocol's 40)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to run on the host)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .eval import main as eval_main
    from .measure_fps import measure_fps

    points = []
    for spec in args.grid.split(","):
        r, g = (int(x) for x in spec.strip().split("x"))
        if r <= 0 or g <= 0:
            raise ValueError(f"--grid point {spec!r}: iterations must be positive")
        points.append((r, g))

    rows = []
    for r, g in points:
        eval_argv = ["--config_path", args.config_path, "--ckpt_path", args.ckpt_path,
                     "--render_iters", str(r), "--gru_iters", str(g),
                     "--eval_batch", str(args.eval_batch), "--device", args.device]
        if args.max_frames:
            eval_argv += ["--max_frames", str(args.max_frames)]
        if args.desc_tail_res:
            eval_argv += ["--desc_tail_res", args.desc_tail_res]
        overall = eval_main(eval_argv)
        row = {"render_iters": r, "gru_iters": g,
               **{k: round(float(v), 5) for k, v in overall.items()}}
        if not args.skip_fps:
            fps1, gf1, reps1 = measure_fps(1, r, g, args.device, args.fps_scene,
                                           args.fps_frames)
            fps8, _, reps8 = measure_fps(8, r, g, args.device, args.fps_scene,
                                         args.fps_frames)
            row.update({
                "fps_b1": round(fps1, 2), "fps_b8": round(fps8, 2),
                "fps_b1_runs": [round(x, 2) for x in reps1],
                "fps_b8_runs": [round(x, 2) for x in reps8],
                "flop_counter_gflops_per_frame_b1": round(gf1, 2),
            })
        print("FRONTIER " + json.dumps(row), flush=True)
        rows.append(row)

    keys = ["add01", "add005", "add002", "add_dist", "rot_err_deg"]
    have_fps = bool(rows) and "fps_b1" in rows[0]
    hdr = "| RxG | " + " | ".join(keys) + (" | fps B=1 | fps B=8 |" if have_fps else " |")
    print("\n" + hdr)
    print("|" + "---|" * (len(keys) + 1 + (2 if have_fps else 0)))
    for row in rows:
        cells = [f"{row['render_iters']}x{row['gru_iters']}"]
        cells += [f"{row.get(k, float('nan')):.4g}" for k in keys]
        if have_fps:
            cells += [f"{row['fps_b1']:.1f}", f"{row['fps_b8']:.1f}"]
        print("| " + " | ".join(cells) + " |")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
