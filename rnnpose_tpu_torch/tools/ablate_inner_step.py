"""Time each sub-op of one GRU + LM inner step (port of
`rnnpose_tpu/tools/ablate_inner_step.py`).

At the shipping operating point (B=8, a 240^2 crop on a 30^2 coarse grid,
bf16 features, the f32 LM), with seeded random inputs and weights, each
sub-op of one inner iteration runs alone: the correlation pyramid build
(once per render iteration), the correlation lookup r=4, the update block
with and without the upsample-mask head, one LM step on the 1/8 grid, and
the similarity weight with and without the resize to the crop. Per sub-op
`profile_components.time_component` reports the host ms of a call, the
CUDA-event ms per call of back-to-back calls and the device ms per call
(`utils/profiling.device_busy`); on the CPU only the host ms.

`--scan N` times each sub-op as an N-long chain instead (each call's output
feeding the next, so nothing is skipped) beside the floor of an empty
chain; the per-iteration time is (chain - floor) / N, on the CUDA events on
the card and on the host clock on the CPU, and the composed inner step is
timed the same way beside the sum of its parts. The JAX tool's `bandmm`
correlation lookup is a TPU lowering: it prints as "n/a".

Usage:
  python -m rnnpose_tpu_torch.tools.ablate_inner_step [--batch 8] [--iters 20]
      [--scan N] [--size 240] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json

from .train import positive_int


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="time the sub-ops of one inner step")
    p.add_argument("--batch", type=positive_int, default=8)
    p.add_argument("--iters", type=positive_int, default=20)
    p.add_argument("--scan", type=int, default=0,
                   help="N>0: time each sub-op over an N-long chain, per iteration")
    p.add_argument("--size", type=positive_int, default=240,
                   help="zoom crop side (the coarse grid is size/8)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: cuda; pass cpu to run on the host)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    import torch.nn.functional as F

    from ..geometry import lm as lm_lib
    from ..models.raft import BasicUpdateBlock
    from ..ops import corr as corr_ops
    from ..ops.sampler import bilinear_sample
    from .profile_components import time_component

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible; pass "
                           "--device cpu to run on the host")
    if device.type == "cuda":
        # The LM runs in exact f32, as the forward runs it.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    B, S = args.batch, args.size
    s8 = S // 8
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)

    fmap1 = randn(B, s8, s8, 256, dtype=bf16)
    fmap2 = randn(B, s8, s8, 256, dtype=bf16)
    coords = torch.rand(B, s8, s8, 2, generator=gen).to(device) * (s8 - 1)
    pyr = corr_ops.build_corr_pyramid(fmap1, fmap2, 4)
    corr_feats = corr_ops.corr_lookup(pyr, coords, 4)
    h0 = torch.tanh(randn(B, s8, s8, 128, dtype=bf16))
    inp = torch.relu(randn(B, s8, s8, 128, dtype=bf16))
    flow = randn(B, s8, s8, 2)
    torch.manual_seed(0)
    blk = BasicUpdateBlock(4 * 81, dtype=bf16).to(device).eval()
    depth_lr = torch.full((B, s8, s8), 0.6, device=device)
    K_lr = (torch.tensor([260.0, 260.0, 120.0, 120.0], device=device) / 8.0).expand(B, 4)
    w_lr = torch.ones(B, s8, s8, 2, device=device)
    T0 = torch.eye(4, device=device).expand(B, 4, 4).contiguous()
    geo1 = randn(B, s8, s8, 32)
    geo2 = randn(B, s8, s8, 32)

    def upd_all(h, c):
        h2, d = blk(h, inp, c, flow)
        return h2, d, blk.upsample_mask(h2)

    def upd_nomask(h, c):
        return blk(h, inp, c, flow)

    def lm(t, c):
        return lm_lib.reprojection_optim(t, c, w_lr, depth_lr, K_lr, 1)

    def simw_lr_only(c):
        dot = torch.sum(geo1 * bilinear_sample(geo2, c), dim=-1, keepdim=True)
        return torch.exp(-torch.abs(1.0 - dot))

    def simw(c):
        w = simw_lr_only(c).permute(0, 3, 1, 2)
        return F.interpolate(w, size=(S, S), mode="bilinear", align_corners=False)

    print(f"B={B}, crop {S}^2 -> coarse {s8}^2, bf16 features, f32 LM, on {device}",
          flush=True)
    results = {}

    def run(name, fn, iters=args.iters):
        results[name] = time_component(name, fn, device, iters)
        return results[name]

    with torch.no_grad():
        if args.scan <= 0:
            run("corr pyramid build (1x/render)",
                lambda: corr_ops.build_corr_pyramid(fmap1, fmap2, 4).levels[0])
            run("corr lookup r=4", lambda: corr_ops.corr_lookup(pyr, coords, 4))
            print(f"{'corr lookup r=4 bandmm':34s} n/a (a TPU lowering)", flush=True)
            run("update block +mask head", lambda: upd_all(h0, corr_feats))
            run("update block (no mask head)", lambda: upd_nomask(h0, corr_feats))
            run(f"LM 1-step @ {s8}^2", lambda: lm(T0, coords))
            run("sim weight + resize", lambda: simw(coords))
            run("sim weight lr-only", lambda: simw_lr_only(coords))
            summary = {"device": device.type, "batch": B, "size": S, "scan": 0,
                       "components": results}
            print(json.dumps(summary), flush=True)
            return summary

        N = args.scan
        clock = "events_ms" if device.type == "cuda" else "host_ms"
        tiny = 1e-6
        per_iter = {}

        def scan_time(f, init, name):
            def chain():
                c = init
                for _ in range(N):
                    c = f(c)
                return c

            r = run(f"[chain x{N}] {name}", chain, max(args.iters // N, 2))
            r0 = run(f"[floor]    {name}", lambda: init, max(args.iters // N, 2))
            per = (r[clock] - r0[clock]) / N
            per_iter[name] = per
            print(f"  -> {name}: {per:.3f} ms/iter", flush=True)
            return per

        total = scan_time(lambda c: c + tiny * corr_ops.corr_lookup(pyr, c, 4).float().mean(),
                          coords, "corr lookup r=4")
        print(f"  -> corr lookup r=4 bandmm: n/a (a TPU lowering)", flush=True)

        def upd_step(h):
            h2, d = upd_nomask(h, corr_feats)
            return h2 + (tiny * d.mean()).to(h2.dtype)

        def upd_mask_step(h):
            h2, d, m = upd_all(h, corr_feats)
            return h2 + (tiny * (d.mean() + m.mean())).to(h2.dtype)

        total += scan_time(upd_step, h0, "update block (no mask head)")
        scan_time(upd_mask_step, h0, "update block +mask head")
        total += scan_time(lambda t: lm(t, coords), T0, f"LM 1-step @ {s8}^2")
        total += scan_time(lambda c: c + tiny * simw_lr_only(c), coords, "sim weight lr-only")
        scan_time(lambda c: c + tiny * simw(c).mean(), coords, "sim weight + resize")

        def full_step(carry):
            c, h, t = carry
            cf = corr_ops.corr_lookup(pyr, c, 4)
            h2, d = blk(h, inp, cf, flow)
            c2 = c + d.float()
            w = simw_lr_only(c2)
            t2 = lm_lib.reprojection_optim(t, c2, w.expand(c2.shape), depth_lr, K_lr, 1)
            return c2, h2, t2

        full = scan_time(full_step, (coords, h0, T0), "FULL inner step (composed)")
        print(f"sum of parts {total:.3f} ms vs composed {full:.3f} ms", flush=True)
    summary = {"device": device.type, "batch": B, "size": S, "scan": N, "clock": clock,
               "per_iter_ms": per_iter, "sum_of_parts_ms": total, "composed_ms": full,
               "components": results}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
