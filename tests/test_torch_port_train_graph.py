"""The compiled training step: the port's `Trainer` (one program per batch
key; on the CPU the program runs the eager step on its static buffers in
place of the replays) and its device-side update (`train/optim.DeviceAdam`)
against the JAX package's jitted train step and optax chain.

* Three distinct batches (the `__graft_entry__._tiny_setup` training scene,
  B=2, f32, each with its own small rigid move of the initial pose) through
  the jitted JAX step and through one `Trainer` program: loss and grad_norm
  within rtol 1e-3, as `test_torch_port_train_step.py` holds them.
* A NaN batch: skipped_nonfinite 1, and the update count, every parameter
  and every moment unchanged bit for bit.
* `load_state_dict` after steps: the next step equals that of a fresh
  trainer loaded with the same state, bit for bit.
* The device-side lr and beta1 against the JAX package's jitted schedules
  at counts 0, 1, a1 - 1, a1, a1 + 1 and total - 1, within rtol 1e-6 (the
  ulps are printed).
* The key: another batch shape makes another program and the same shape
  reuses one; the pyramid's and the correspondences' leaves are in it;
  batched leaves that disagree on the batch raise ValueError.
* A state written by the optimizer before the device-side update
  (`torch.optim.AdamW` under "adam") resumes, and AdamW reads the new one.
* `tools/overfit_check.clip_adam` against the JAX tool's
  `optax.chain(clip_by_global_norm(10), adam(lr))`.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import _torch_port_train_common as T
from rnnpose_tpu.train import loop as jloop
from rnnpose_tpu.train import optim as jopt
from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
from rnnpose_tpu_torch.models.engine import _flatten, _key
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_
from rnnpose_tpu_torch.tools.overfit_check import clip_adam
from rnnpose_tpu_torch.train import optim as topt
from rnnpose_tpu_torch.train.loop import Trainer
from rnnpose_tpu_torch.train.optim import OptimizerConfig


def _moved(inputs, k):
    """The JAX inputs with T_init moved by a small seeded rigid motion."""
    rs = np.random.RandomState(100 + k)
    T0 = np.array(inputs.T_init)
    dT = np.tile(np.eye(4, dtype=np.float32), (T0.shape[0], 1, 1))
    dT[:, :3, :3] = Rotation.from_rotvec(rs.randn(T0.shape[0], 3) * 0.01).as_matrix()
    dT[:, :3, 3] = rs.randn(T0.shape[0], 3) * 0.002
    return inputs._replace(T_init=jnp.asarray((dT @ T0).astype(np.float32)))


def _state(trainer):
    opt = trainer.state.optimizer
    return ({n: p.detach().clone() for n, p in trainer.model.named_parameters()},
            [m.clone() for m in opt.m], [v.clone() for v in opt.v], opt.count.clone())


def _assert_state_equal(a, b):
    pa, ma, va, ca = a
    pb, mb, vb, cb = b
    assert torch.equal(ca, cb)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    for x, y in zip(ma + va, mb + vb):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def runs():
    jmodel, params, inputs = T.jax_train_setup(batch_size=2, render_iters=1)
    batches = [_moved(inputs, k) for k in range(3)]
    tx = jopt.build_optimizer(jopt.OptimizerConfig(), params)
    step = jloop.make_train_step(jmodel, tx, donate=False)
    p, o = params, tx.init(params)
    jax_m = []
    for b in batches:
        p, o, m = step(p, o, b)
        jax_m.append({k: float(v) for k, v in m.items()})

    trainer = Trainer(T.port_model(jmodel, params), OptimizerConfig())
    port_batches = [T.port_train_inputs(b) for b in batches]
    port_m, after_first = [], None
    for b in port_batches:
        port_m.append({k: float(v) for k, v in trainer.run_step(b).items()})
        if after_first is None:
            after_first = copy.deepcopy(trainer.state_dict())
    return dict(jax_m=jax_m, port_m=port_m, trainer=trainer, batches=port_batches,
                after_first=after_first, fresh=lambda: Trainer(T.port_model(jmodel, params),
                                                               OptimizerConfig()))


def test_program_matches_jitted_jax_step(runs):
    jax_m, port_m, trainer = runs["jax_m"], runs["port_m"], runs["trainer"]
    assert trainer.state.step == 3 and int(trainer.state.optimizer.count) == 3
    assert trainer.graph_captures == 1 and len(trainer._programs) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in port_m], [m[k] for m in jax_m],
                                   rtol=1e-3, err_msg=k)
    assert [m["skipped_nonfinite"] for m in port_m] == [m["skipped_nonfinite"] for m in jax_m]
    assert all(m["skipped_nonfinite"] == 0.0 for m in port_m)
    assert len({m["loss"] for m in port_m}) == 3  # distinct batches, moving weights


def test_nan_step_keeps_state_bitwise(runs):
    trainer, batch = runs["trainer"], runs["batches"][0]
    before = _state(trainer)
    step = trainer.state.step
    bad = batch._replace(image=torch.full_like(batch.image, float("nan")))
    m = trainer.run_step(bad)
    assert float(m["skipped_nonfinite"]) == 1.0 and not np.isfinite(float(m["grad_norm"]))
    assert trainer.state.step == step + 1 and trainer.graph_captures == 1
    _assert_state_equal(_state(trainer), before)


def test_load_state_dict_then_step_is_a_fresh_trainers(runs):
    """The trainer has a program; loading the state after the first step
    into it and into a fresh trainer, then one step on each: bitwise
    equal metrics and state."""
    trainer, batch, saved = runs["trainer"], runs["batches"][2], runs["after_first"]
    trainer.load_state_dict(saved)
    assert int(trainer.state.optimizer.count) == 1 and trainer.state.step == 1
    got = trainer.run_step(batch)
    fresh = runs["fresh"]()
    fresh.load_state_dict(saved)
    want = fresh.run_step(batch)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    _assert_state_equal(_state(trainer), _state(fresh))
    assert int(trainer.state.optimizer.count) == 2


@pytest.mark.parametrize("cfg", [{}, dict(total_steps=10, pct_start=0.25),
                                 dict(total_steps=5000, pct_start=0.3, lr_max=3e-4)],
                         ids=["default", "short", "long_start"])
def test_device_schedules_match_jitted_jax(cfg):
    jcfg, pcfg = jopt.OptimizerConfig(**cfg), OptimizerConfig(**cfg)
    a1 = int(jcfg.total_steps * jcfg.pct_start)
    counts = [0, 1, a1 - 1, a1, a1 + 1, jcfg.total_steps - 1]
    for name, jsched, psched in (
            ("lr", jopt.one_cycle_schedule(jcfg), topt.one_cycle_schedule_tensor(pcfg)),
            ("beta1", jopt.one_cycle_momentum_schedule(jcfg),
             topt.one_cycle_momentum_schedule_tensor(pcfg))):
        jitted = jax.jit(jsched)
        want = np.array([np.asarray(jitted(jnp.int32(c))) for c in counts], np.float32)
        got = np.array([psched(torch.tensor(c, dtype=torch.int32)).numpy() for c in counts],
                       np.float32)
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        print(f"{name} {cfg}: counts {counts} ulps {ulps.tolist()}")
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def _tiny_port(batch_size, num_corr=64):
    syn = SyntheticConfig(batch_size=batch_size, image_size=64, num_verts=128, num_faces=256,
                          subdivisions=2, kp_layers=2, kp_dl=0.03, num_corr=num_corr)
    kp = dataclasses.replace(kpconv_config(syn), first_feats_dim=16, gnn_feats_dim=16)
    cfg = RNNPoseConfig(desc_kp=dataclasses.replace(kp, final_feats_dim=32),
                        ctx_kp=dataclasses.replace(kp, final_feats_dim=256,
                                                   normalize_output=False),
                        refiner=RefinerConfig(zoom_crop_size=32, render_iters=1, gru_iters=1,
                                              corr_levels=2, raster_chunk=64))
    return cfg, make_synthetic_inputs(syn, with_corr=True)


def test_program_key():
    cfg, b2 = _tiny_port(2)
    paths = [p for p, _ in _flatten(b2, "", [])]
    assert "pyramid.points.0" in paths and "pyramid.upsamples.0" in paths
    assert "corr.px" in paths and "corr.valid" in paths
    shorter = b2._replace(pyramid=type(b2.pyramid)(
        b2.pyramid.points, b2.pyramid.masks, b2.pyramid.neighbors, b2.pyramid.pools,
        [u[:, :, :1] for u in b2.pyramid.upsamples]))
    assert _key(_flatten(shorter, "", [])) != _key(_flatten(b2, "", []))

    trainer = Trainer(init_random_(RNNPose(cfg), torch.Generator().manual_seed(0)),
                      OptimizerConfig())
    trainer.run_step(b2)
    trainer.run_step(b2._replace(image=b2.image.flip(1)))
    assert trainer.graph_captures == 1
    _, fewer = _tiny_port(2, num_corr=32)
    trainer.run_step(b2._replace(corr=fewer.corr))
    assert trainer.graph_captures == 2
    _, b1 = _tiny_port(1)
    trainer.run_step(b1)
    assert trainer.graph_captures == 3 and trainer.state.step == 4
    mixed = b2._replace(corr=b1.corr)
    with pytest.raises(ValueError, match="corr.px has batch 1, the image 2"):
        trainer.run_step(mixed)
    with pytest.raises(ValueError, match="pyramid.points.0 has batch 1"):
        trainer.run_step(b2._replace(pyramid=b1.pyramid))
    assert trainer.graph_captures == 3 and trainer.state.step == 4


def test_adamw_state_resumes():
    """A checkpoint of the optimizer before the device-side update (AdamW
    under "adam", count an int) loads into `ScheduledAdam`, which then
    steps from it; AdamW loads the new layout back."""
    cfg, batch = _tiny_port(2)
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(1))
    ocfg = OptimizerConfig(total_steps=20)
    sched = topt.ScheduledAdam(ocfg, model)
    adamw = torch.optim.AdamW(sched.params, lr=sched.lr(0), betas=(sched.mom(0), 0.99),
                              eps=1e-8, weight_decay=ocfg.weight_decay)
    rs = np.random.RandomState(0)
    for count in range(2):
        for p in sched.params:
            p.grad = torch.from_numpy((rs.randn(*p.shape) * 1e-3).astype(np.float32))
        for group in adamw.param_groups:
            group["lr"], group["betas"] = sched.lr(count), (sched.mom(count), 0.99)
        adamw.step()
    old = {"model": model.state_dict(), "step": 2,
           "optimizer": {"adam": copy.deepcopy(adamw.state_dict()), "count": 2}}

    trainer = Trainer(init_random_(RNNPose(cfg), torch.Generator().manual_seed(2)), ocfg)
    trainer.load_state_dict(old)
    opt = trainer.state.optimizer
    assert int(opt.count) == 2 and opt.count.dtype == torch.int32
    for i, (m, v) in enumerate(zip(opt.m, opt.v)):
        assert torch.equal(m, adamw.state[adamw.param_groups[0]["params"][i]]["exp_avg"])
        assert torch.equal(v, adamw.state[adamw.param_groups[0]["params"][i]]["exp_avg_sq"])
    m = trainer.run_step(batch)
    assert float(m["skipped_nonfinite"]) == 0.0 and int(opt.count) == 3

    new = trainer.state_dict()["optimizer"]
    assert new["count"] == 3 and set(new["adam"]) == {"state", "param_groups"}
    reader = torch.optim.AdamW([torch.zeros_like(p) for p in opt.params])
    reader.load_state_dict(copy.deepcopy(new["adam"]))
    for i, p in enumerate(reader.param_groups[0]["params"]):
        assert torch.equal(reader.state[p]["exp_avg"], opt.m[i])
        assert torch.equal(reader.state[p]["exp_avg_sq"], opt.v[i])
        assert float(reader.state[p]["step"]) == 3.0


def test_clip_adam_matches_optax_chain():
    """The overfit tool's optimizer: every parameter, clip 10, Adam at a
    constant lr with betas (0.9, 0.999), no decay; four gradient sets, the
    second clipped. Parameters within 1e-6 of the optax chain's."""
    cfg, _ = _tiny_port(1)
    model = init_random_(RNNPose(cfg), torch.Generator().manual_seed(3))
    params = dict(model.named_parameters())
    p0 = {n: p.detach().numpy().copy() for n, p in params.items()}
    rs = np.random.RandomState(1)
    grads = [{n: (rs.randn(*x.shape) * 1e-3 * (300.0 if k == 1 else 1.0)).astype(np.float32)
              for n, x in p0.items()} for k in range(4)]
    lr = 2e-4

    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(lr))
    jp = {n: jnp.asarray(x) for n, x in p0.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update({n: jnp.asarray(x) for n, x in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)

    opt = clip_adam(model, lr)
    for g in grads:
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step(torch.tensor(True))
    assert int(opt.count) == 4
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=0, atol=1e-6,
                                   err_msg=n)
        assert not np.array_equal(p.detach().numpy(), p0[n]), n
