"""Export the eval forward as a serving bundle (port of
`rnnpose_tpu/tools/export_model.py`).

Usage:
  python -m rnnpose_tpu_torch.tools.export_model --out DIR \\
      [--platform cuda|cpu] [--batch 1] [--ckpt PATH] [--parity] [--f32] \\
      [--selftest] [--save_example FILE]

Writes the bundle directory of `utils/export.save_exported` (the format is
`utils/bundle.py`): `model.pt2` (`torch.export`), `manifest.json`
(signature, device, per-leaf tree paths, shapes and dtypes, the raster
choices, the TF32 switch), copies of the `kernels/` package and
`utils/bundle.py` and, for `cuda`, the kernel libraries. The artifact is
`(T_init, *leaves) -> Ti_pred`; a process without this package loads the
bundle through the bundle's own `bundle.py` (`tools/serve_bundle.py`).
`--save_example` writes the example `T_init`, leaves and the expected
`Ti_pred` (`torch.load`-able; `utils/export.save_example`); on `cuda` the
expected output is computed under `torch.use_deterministic_algorithms(True)`,
so a consumer in that mode reproduces it.

The example batch is the shipping LINEMOD operating point (320^2 input,
240^2 crop, 2048/4096 mesh budget, 4-layer 128-wide KPConv towers, 3 x 4
iterations) unless flags override; the weights are random (seed 0) or, with
`--ckpt`, the model of a port checkpoint (`train/checkpoint.py`).
`--parity` exports `apply_parity_preset`'s forward, `--f32` the refiner
without mixed precision. `--platform` defaults to `cuda` and raises where no
card is visible. Sizes and iteration counts must be positive; a bad value
is refused before anything is written. The last stdout line is a JSON
summary: the manifest's device, operator nodes and bytes, and with
`--selftest` the max |artifact - direct forward| (limit 1e-5) and the
kernel launches counted while the reloaded artifact ran.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from .train import positive_int

SELFTEST_TOL = 1e-5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rnnpose_tpu_torch serving export")
    p.add_argument("--out", required=True, help="the bundle directory")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--batch", type=positive_int, default=1)
    p.add_argument("--image_size", type=positive_int, default=320)
    p.add_argument("--verts", type=positive_int, default=2048)
    p.add_argument("--faces", type=positive_int, default=4096)
    p.add_argument("--ckpt", type=str, default=None, help="a port checkpoint")
    p.add_argument("--zoom", type=positive_int, default=240)
    p.add_argument("--render_iters", type=positive_int, default=3)
    p.add_argument("--gru_iters", type=positive_int, default=4)
    p.add_argument("--corr_levels", type=positive_int, default=4,
                   help="correlation pyramid depth; must satisfy "
                   "(zoom/8) >> (corr_levels-1) >= 1")
    p.add_argument("--raster_chunk", type=positive_int, default=128)
    p.add_argument("--parity", action="store_true",
                   help="export the reference-exact forward (apply_parity_preset)")
    p.add_argument("--f32", action="store_true",
                   help="the refiner in f32 (mixed_precision off)")
    p.add_argument("--selftest", action="store_true",
                   help="reload the bundle and check it against the direct forward "
                   f"on the example batch (max |d| < {SELFTEST_TOL})")
    p.add_argument("--save_example", type=str, default=None,
                   help="write the example T_init, leaves and expected Ti_pred "
                   "(torch.load-able) for a standalone consumer")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    device = torch.device(args.platform)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--platform cuda: no CUDA device is visible; pass "
                               "--platform cpu to export for the host")
        # cuBLAS is deterministic (for the example) only with a fixed
        # workspace, set before its first handle.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    from ..data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
    from ..models.refiner import RefinerConfig
    from ..models.rnnpose import RNNPose, RNNPoseConfig, apply_parity_preset, init_random_
    from .. import kernels
    from ..utils import export as ex

    syn = SyntheticConfig(
        image_size=args.image_size, batch_size=args.batch,
        num_verts=args.verts, num_faces=args.faces,
        subdivisions=4 if args.verts >= 1024 else 3,
        kp_layers=4, kp_dl=0.006,
    )
    inputs = make_synthetic_inputs(syn, device=device)
    kp = kpconv_config(syn)
    cfg = RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32, first_feats_dim=128,
                                    gnn_feats_dim=128),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, first_feats_dim=128,
                                   gnn_feats_dim=128, normalize_output=False),
        refiner=RefinerConfig(
            zoom_crop_size=args.zoom, render_iters=args.render_iters,
            gru_iters=args.gru_iters, corr_levels=args.corr_levels,
            raster_chunk=args.raster_chunk, mixed_precision=not args.f32,
        ),
    )
    if args.parity:
        cfg = apply_parity_preset(cfg)
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(0))
    if args.ckpt:
        from ..train.checkpoint import restore_checkpoint

        model.load_state_dict(restore_checkpoint(args.ckpt, map_location="cpu")["model"])
    model = model.to(device).eval()
    desc3d, ctx3d = model.encode_3d(inputs.pyramid)

    exported = ex.export_eval_forward(model, inputs, desc3d, ctx3d)
    manifest = ex.save_exported(
        exported, args.out, ex.serving_leaf_paths(model, inputs, desc3d, ctx3d),
        extra_manifest={"image_size": args.image_size, "batch": args.batch,
                        "parity": args.parity, "f32": args.f32 or args.parity})
    nodes = manifest["operators"]["nodes"]
    print(f"wrote {args.out} ({manifest['bundle_bytes']} bytes, program "
          f"{manifest['bytes']}) device={manifest['device']} operator nodes {nodes}")

    summary = {"device": manifest["device"], "bytes": manifest["bytes"],
               "bundle_bytes": manifest["bundle_bytes"], "operator_nodes": nodes}
    if args.selftest or args.save_example:
        reloaded, _ = ex.load_exported(args.out)
        run = reloaded.module()
        leaves = ex.serving_args(model, inputs, desc3d, ctx3d)
        before = kernels.LAUNCHES.copy()
        if args.save_example:
            got = ex.save_example(args.save_example, run, inputs.T_init, leaves)
            print(f"wrote example batch to {args.save_example} ({len(leaves)} leaves)")
        else:
            got = run(inputs.T_init, *leaves)
        summary["artifact_launches"] = {k: kernels.LAUNCHES[k] - before[k]
                                        for k in kernels.OPERATORS}
    if args.selftest:
        want = model(inputs, cached_desc3d=desc3d, cached_ctx3d=ctx3d)["Ti_pred"]
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        summary["selftest_max_abs_diff"] = err
        if not (err < SELFTEST_TOL and finite):
            raise RuntimeError(f"selftest mismatch: max |d| {err} (limit {SELFTEST_TOL}), "
                               f"finite {finite}")
        print(f"selftest OK (max|d|={err:.2e}), poses finite={finite}, artifact launches "
              f"{summary['artifact_launches']}")
    print(json.dumps(summary), flush=True)
    return manifest, summary


if __name__ == "__main__":
    main()
