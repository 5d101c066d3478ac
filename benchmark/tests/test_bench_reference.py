"""The frozen reference against the program's eager modules, at the port's
`tiny` scene on the CPU: the same weights and inputs give the same eval
forward and the same training step."""
from __future__ import annotations

import pytest
import torch

from benchmark import build, gen
from benchmark.tests._bench_common import tiny_config

pytestmark = pytest.mark.filterwarnings("ignore")


def _pair(cfg, seed=7):
    scene = gen.make_scene(cfg, 2, seed, torch.device("cpu"))
    prog, ref = build.side("program"), build.side("reference")
    pm = build.build_model(prog, cfg, "cpu", f32=True)
    rm = build.build_model(ref, cfg, "cpu", f32=True)
    w = gen.make_weights(pm, seed, torch.device("cpu"))
    build.load_weights(pm, w)
    build.load_weights(rm, w)
    return scene, prog, ref, pm, rm


@pytest.mark.parametrize("parity", [False, True], ids=["serving", "parity"])
def test_reference_matches_program_eval_forward(parity):
    torch.manual_seed(0)
    cfg = tiny_config("tiny", parity)
    scene, prog, ref, pm, rm = _pair(cfg)
    with torch.no_grad():
        outs = []
        for mods, m in ((prog, pm), (ref, rm)):
            inputs = gen.as_inputs(mods, scene)
            d3, c3 = m.encode_3d(inputs.pyramid)
            outs.append(m(inputs, cached_desc3d=d3, cached_ctx3d=c3))
    p, r = outs
    for key in ("Ti_pred", "Tij"):
        torch.testing.assert_close(p[key], r[key], rtol=0, atol=1e-6)
    for f in ("flow_history", "Ti_history", "syn_depth_history", "weight"):
        torch.testing.assert_close(getattr(p["refiner"], f), getattr(r["refiner"], f),
                                   rtol=0, atol=1e-5)


def test_reference_matches_program_training_step():
    from rnnpose_tpu_torch.train.loop import make_train_step as prog_step
    from rnnpose_tpu_torch.train.optim import OptimizerConfig as ProgOpt
    from rnnpose_tpu_torch.train.optim import build_optimizer as prog_opt

    from benchmark.reference.train.optim import OptimizerConfig, build_optimizer
    from benchmark.reference.train.step import make_train_step

    cfg = tiny_config("tiny")
    scene, prog, ref, pm, rm = _pair(cfg, seed=11)
    corr = gen.make_corr(scene, 64, 3)
    popt, ropt = prog_opt(ProgOpt(), pm), build_optimizer(OptimizerConfig(), rm)
    pstep, rstep = prog_step(pm, popt), make_train_step(rm, ropt)
    for k in range(2):
        image = (scene.image + 0.01 * k).clamp(0, 1)
        mp = pstep(gen.as_inputs(prog, scene, image=image, corr=corr))
        mr = rstep(gen.as_inputs(ref, scene, image=image, corr=corr))
        for key in ("loss", "circle_loss", "flow_loss", "grad_norm"):
            torch.testing.assert_close(mp[key], mr[key], rtol=1e-5, atol=1e-7)
    for (n, a), (_, b) in zip(pm.named_parameters(), rm.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=n)
    for a, b in zip(popt.m + popt.v, ropt.m + ropt.v):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)
    assert int(popt.count) == int(ropt.count) == 2
