"""What decides `correct`: the program's outputs against the plain
reference (`benchmark/reference`, f32, TF32 off, the plain raster).

Serving (`check_serving`). The refinement is iterative, and a 1-ulp move of
the initial pose moves the full 3 x 4 budget's flow by ~0.2 px (PERF.md),
so the reference follows the program one render iteration at a time: for
each sampled request, frame b and render iteration r it starts from the
program's own pose at the start of r (`Ti_history[r * G]`; for r = 0 the
request's `T_init`) and runs that render iteration whole (zoom crop,
raster, 3D feature interpolation from its own `encode_3d`, SuperPoint
descriptors of the image, the RAFT encoder and pyramid, G GRU and LM
steps). A render iteration reads nothing else from the one before it, so
this covers every stage. Compared, as the largest over the sample:
  * `pose_gap_px`: the mean distance, in pixels of the full image, between
    the mesh's valid vertices projected at the program's pose after r (the
    start of r + 1, or the answer `Ti_pred` after the last) and at the
    reference's;
  * `flow_gap_px`: the mean over the flow grid of |flow_prog - flow_ref| at
    the worst of the G inner steps;
  * `pose_gap_p90_px`, `flow_gap_p90_px`: the same per item, at the 90th
    percentile of the items: one item that rounds apart (a pixel of the
    raster on an edge) does not move it, a fault in a tenth of the items
    or more does.

Training (`check_training`). Each side's record holds two phases
(`train.PHASES`): the first steps from the seed's weights (the program's
eager warm-ups and its capture) and the next ones, all replays of the
captured graphs. The reference follows each phase on the same batches from
the state that side started it from: the seed's weights, then the side's
own parameters, moments and count after the first phase (so the replays
are judged alone; the first phase judges the start). Compared, each the
worst over both phases:
  * `loss_gap`: each step's loss, |prog - ref| / |ref|;
  * `term_gap`: each step's loss terms (circle, flow, 3D projection), each
    over max(|ref term|, |ref loss| / 100): a term under a hundredth of the
    loss is judged by its share of the loss;
  * `grad_norm_gap`: each step's global gradient norm, as the loss;
  * `grad_gap`: the gradient as the optimizer got it at the first step;
  * `delta_gap`: the parameters' change over the phase;
  * `moment_gap`: both moments at the phase's end, the median leaf's gap
    (the worst leaf's is the noise of the 3D towers' coarse levels, whose
    gradients sum over a handful of points; PERF.md);
  * `count_gap`: |count_prog - count_ref| at the phase's end (exact).
A leaf gap is |norm_prog - norm_ref| over max(norm_ref, the median leaf's
norm_ref), of the worst leaf unless said otherwise. Leaves whose reference
gradient at the first step is under a thousandth of the median leaf's are
left out of the change (round-off moves them under Adam). The
configuration's limits name the numbers compared.
"""
from __future__ import annotations

import statistics
from typing import Any, Dict, List

import torch

from . import build, gen
from .reference.geometry import projective as proj

__all__ = ["exact_f32", "check_serving", "check_training", "serving_items"]


def exact_f32(tf32: bool = False) -> None:
    """TF32 off for matmuls and cuDNN (the reference); on for the control
    of a float32 configuration."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def serving_items(samples: List[Dict[str, torch.Tensor]], R: int, G: int):
    """One item per (request, frame, render iteration): the image, the start
    pose (the request's T_init, then the program's pose at the start of the
    render iteration), the program's pose after it (the next one's start,
    or the answer, Ti_pred) and its G flows."""
    items = []
    for s in samples:
        B = s["image"].shape[0]
        for b in range(B):
            for r in range(R):
                items.append(dict(
                    image=s["image"][b], b=b,
                    start=s["T_init"][b] if r == 0 else s["Ti_history"][r * G, b],
                    pose=s["Ti_pred"][b] if r == R - 1 else s["Ti_history"][(r + 1) * G, b],
                    flows=s["flow_history"][r * G:(r + 1) * G, b]))
    return items


def _pixels(T, verts, K):
    """(n, V, 2) projections of verts (V, 3) under poses T (n, 4, 4), K (n, 4)."""
    uv, _ = proj.project(proj.transform_points(T, verts[None].expand(T.shape[0], -1, -1)),
                         K[:, None, :])
    return uv


@torch.no_grad()
def check_serving(cfg: Dict[str, Any], scene: gen.Scene, weights, samples, device,
                  block: int = 8) -> Dict[str, float]:
    """The serving numbers over `samples` (see the module docstring), the
    reference's render iterations run `block` at a time."""
    mods = build.side("reference")
    rn, _ = mods
    G, R = cfg["gru_iters"], cfg["render_iters"]
    exact_f32()
    model = build.build_model(mods, cfg, device, f32=True, render_iters=1).eval()
    build.load_weights(model, weights)
    base = gen.as_inputs(mods, scene)
    desc3d, ctx3d = model.encode_3d(base.pyramid)
    items = serving_items(samples, R, G)
    valid = scene.mesh["vert_valid"] > 0
    verts = scene.mesh["verts"][valid]
    pose_gaps, flow_gaps = [], []
    for i in range(0, len(items), block):
        chunk = items[i:i + block]
        bs = torch.tensor([it["b"] for it in chunk], device=device)
        n = len(chunk)
        inputs = rn.RNNPoseInputs(
            image=torch.stack([it["image"] for it in chunk]),
            intrinsics=scene.intrinsics[bs], T_init=torch.stack([it["start"] for it in chunk]),
            T_gt=None, mesh=base.mesh, model_points=scene.model_points[bs],
            point_valid=scene.point_valid[bs])
        out = model(inputs, cached_desc3d=desc3d[bs], cached_ctx3d=ctx3d[bs])
        K = scene.intrinsics[bs]
        prog_pose = torch.stack([it["pose"] for it in chunk])
        d = (_pixels(prog_pose, verts, K) - _pixels(out["Ti_pred"], verts, K)).norm(dim=-1)
        pose_gaps.append(torch.nan_to_num(d.mean(dim=1), nan=1e9).double().cpu())
        prog_flow = torch.stack([it["flows"] for it in chunk], dim=1)   # (G, n, h, w, 2)
        ref_flow = out["refiner"].flow_history                         # (G, n, h, w, 2)
        fd = (prog_flow.float() - ref_flow.float()).norm(dim=-1).reshape(G, n, -1).mean(-1)
        flow_gaps.append(torch.nan_to_num(fd, nan=1e9).amax(dim=0).double().cpu())
    pose, flow = torch.cat(pose_gaps), torch.cat(flow_gaps)
    return {"pose_gap_px": float(pose.max()), "flow_gap_px": float(flow.max()),
            "pose_gap_p90_px": float(torch.quantile(pose, 0.9)),
            "flow_gap_p90_px": float(torch.quantile(flow, 0.9)), "compared": len(items),
            "items": {"pose": pose.tolist(), "flow": flow.tolist()}}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), median leaf
    norm(ref))} over the leaves `keep` names (default all)."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    pn = {n: float(prog[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    out = {}
    for n in names:
        g = abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
        out[n] = g if g == g else float("inf")
    return out


def leaf_gap(prog, ref, keep=None, stat: str = "max") -> float:
    """The worst (`stat` "max") or the median leaf's gap (`leaf_gaps`)."""
    gaps = leaf_gaps(prog, ref, keep).values()
    return max(gaps) if stat == "max" else statistics.median(gaps)


def _rel(a: float, b: float, floor: float = 0.0) -> float:
    g = abs(a - b) / max(abs(b), floor, 1e-30)
    return g if g == g else float("inf")


def check_training(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The training numbers from the two sides' records (`train.record`,
    one per phase)."""
    norms = {n: float(g.double().norm()) for n, g in ref["start"]["grad"].items()}
    med = statistics.median(norms.values())
    moved = {n for n, v in norms.items() if v >= 1e-3 * med}
    out = dict(loss_gap=0.0, term_gap=0.0, grad_norm_gap=0.0, delta_gap=0.0, moment_gap=0.0,
               count_gap=0.0)
    out["grad_gap"] = leaf_gap(prog["start"]["grad"], ref["start"]["grad"])
    for phase in ref:
        p, r = prog[phase], ref[phase]
        for ps, rs in zip(p["steps"], r["steps"]):
            out["loss_gap"] = max(out["loss_gap"], _rel(ps["loss"], rs["loss"]))
            out["grad_norm_gap"] = max(out["grad_norm_gap"], _rel(ps["grad_norm"], rs["grad_norm"]))
            for t in ("circle_loss", "flow_loss", "loss_3d_proj"):
                out["term_gap"] = max(out["term_gap"],
                                      _rel(ps[t], rs[t], abs(rs["loss"]) / 100.0))
        if len(p["steps"]) != len(r["steps"]):
            out["loss_gap"] = float("inf")

        def change(rec):
            return {n: rec["end"]["params"][n] - rec["begin"]["params"][n] for n in moved}
        out["delta_gap"] = max(out["delta_gap"], leaf_gap(change(p), change(r), keep=moved))
        for key in ("m", "v"):
            out["moment_gap"] = max(out["moment_gap"],
                                    leaf_gap(p["end"][key], r["end"][key], stat="median"))
        out["count_gap"] = max(out["count_gap"],
                               float(abs(p["end"]["count"] - r["end"]["count"])))
    out.update(leaves_compared=len(moved), leaves=len(norms))
    return out
