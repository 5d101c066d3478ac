"""The port's optimizer against the JAX package's optax chain
(`train/optim.build_optimizer`): the same gradient sequence, 5 updates
across the OneCycle boundary, through both. One step's gradients are large
enough to be clipped, one is non-finite (both train loops skip it: no update,
the update count does not advance), and one tensor is frozen by a regex
over flax paths. Parameters agree within 1e-6 and the lr and beta1
schedules within 1e-7 at every step, at the default config and again at a
large lr and decay, where the decoupled weight decay moves the parameters
by far more than the bound. Parameters are compared in the torch
layout on both sides: every term of the chain is elementwise but the
global norm, which the layout does not change.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.train import optim as jopt
from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, kpconv_config
from rnnpose_tpu_torch.models.convert import flax_paths
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_
from rnnpose_tpu_torch.train import optim as topt

FROZEN = r"hybrid/desc2d/conv1a/"
CFG = dict(total_steps=10, pct_start=0.25, freeze_patterns=(FROZEN,))


def _tiny_model():
    kp = dataclasses.replace(kpconv_config(SyntheticConfig(kp_layers=2)),
                             first_feats_dim=16, gnn_feats_dim=16)
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(**C.refiner_kwargs(corr_levels=2))))
    return init_random_(model, torch.Generator().manual_seed(0))


def _nest(flat):
    """{'params/a/b': x} -> {'params': {'a': {'b': x}}}."""
    tree = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = x
    return tree


def _grad_sequence(names, shapes):
    rs = np.random.RandomState(0)
    seq = []
    for k in range(5):
        g = {n: (rs.randn(*shapes[n]) * 1e-3).astype(np.float32) for n in names}
        if k == 1:   # clipped: global norm far above 10
            g = {n: x * 300.0 for n, x in g.items()}
        if k == 2:   # non-finite: skipped by the loops' guard
            g[names[5]][0] = np.nan
        seq.append(g)
    return seq


def _run_both(cfg):
    """The gradient sequence through the optax chain and through the port's
    optimizer, from the same parameters. Returns the port's and the JAX
    package's parameters after it (torch names), the initial parameters,
    the frozen names, and the port's lr and beta1 at each applied update."""
    model = _tiny_model()
    paths = flax_paths(model)
    names = list(paths)
    params0 = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    grads = _grad_sequence(names, {n: x.shape for n, x in params0.items()})

    # JAX: the optax chain of build_optimizer, behind the train loop's guard.
    jcfg = jopt.OptimizerConfig(**cfg)
    jparams = _nest({paths[n]: jnp.asarray(params0[n]) for n in names})
    tx = jopt.build_optimizer(jcfg, jparams)
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    jax_applied = []
    for g in grads:
        gtree = _nest({paths[n]: jnp.asarray(g[n]) for n in names})
        finite = bool(jnp.isfinite(jopt.safe_global_norm(gtree)))
        jax_applied.append(finite)
        if finite:
            updates, state = update(gtree, state, jparams)
            jparams = optax.apply_updates(jparams, updates)

    # The port: ScheduledAdam behind the same guard.
    opt = topt.build_optimizer(topt.OptimizerConfig(**cfg), model)
    params = dict(model.named_parameters())
    lrs, moms = [], []
    for g in grads:
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n].copy())
        if bool(torch.isfinite(topt.safe_global_norm(p.grad for p in params.values()))):
            lrs.append(opt.lr(opt.count))
            moms.append(opt.mom(opt.count))
            opt.step()
    assert jax_applied == [True, True, False, True, True] and opt.count == 4

    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_leaves_with_path(jparams)}
    ours = {n: params[n].detach().numpy() for n in names}
    theirs = {n: np.asarray(flat_j["".join(f"['{c}']" for c in paths[n].split("/"))])
              for n in names}
    frozen = sorted(n for n in names if FROZEN in paths[n])
    assert opt.frozen == frozen and len(frozen) == 2  # conv1a's weight and bias
    return ours, theirs, params0, frozen, lrs, moms


def _assert_params_match(ours, theirs, params0, frozen):
    for n in ours:
        np.testing.assert_allclose(ours[n], theirs[n], rtol=0, atol=1e-6, err_msg=n)
        moved = not np.array_equal(ours[n], params0[n])
        assert moved == (n not in frozen), n


def test_optimizer_matches_optax_chain():
    ours, theirs, params0, frozen, lrs, moms = _run_both(CFG)
    _assert_params_match(ours, theirs, params0, frozen)

    # The schedules at every applied update (OneCycle boundary at count 2).
    jcfg = jopt.OptimizerConfig(**CFG)
    j_lr, j_mom = jopt.one_cycle_schedule(jcfg), jopt.one_cycle_momentum_schedule(jcfg)
    for k, (lr, mom) in enumerate(zip(lrs, moms)):
        np.testing.assert_allclose(lr, float(j_lr(k)), rtol=0, atol=1e-7)
        np.testing.assert_allclose(mom, float(j_mom(k)), rtol=0, atol=1e-7)
    assert lrs[3] < lrs[2] > lrs[1] and moms[3] > moms[2] < moms[1]  # the peak at count 2


def test_weight_decay_matches_optax_chain():
    """The same sequence where the decoupled decay is visible: at the
    default lr 1e-4 and decay 1e-4 its term lr*wd*|p| is ~1e-9 per update,
    far below the 1e-6 bound. At lr 1e-2 and decay 0.1 it is ~1e-3*|p|, and
    the port run without decay must miss the JAX parameters by far more
    than the bound (coupled L2 would too: Adam normalises it away)."""
    cfg = dict(CFG, lr_max=1e-2, weight_decay=0.1)
    ours, theirs, params0, frozen, _, _ = _run_both(cfg)
    _assert_params_match(ours, theirs, params0, frozen)
    no_decay, _, _, _, _, _ = _run_both(dict(cfg, weight_decay=0.0))
    gap = max(float(np.abs(no_decay[n] - theirs[n]).max()) for n in theirs)
    assert gap > 1e-4, gap


@pytest.mark.parametrize("step", [0, 1, 3, 7, 12, 19])
def test_schedules_match_jax(step):
    cfg = dict(total_steps=20, pct_start=0.2)
    jcfg, tcfg = jopt.OptimizerConfig(**cfg), topt.OptimizerConfig(**cfg)
    pairs = [
        (jopt.one_cycle_schedule(jcfg), topt.one_cycle_schedule(tcfg)),
        (jopt.one_cycle_momentum_schedule(jcfg), topt.one_cycle_momentum_schedule(tcfg)),
        (jopt.exponential_decay_schedule(1e-3, 20, 0.25, 0.5),
         topt.exponential_decay_schedule(1e-3, 20, 0.25, 0.5)),
        (jopt.exponential_decay_schedule(1e-3, 20, 0.25, 0.5, staircase=False),
         topt.exponential_decay_schedule(1e-3, 20, 0.25, 0.5, staircase=False)),
        (jopt.manual_stepping_schedule([0.3, 0.6], [1e-3, 5e-4, 1e-4], 20),
         topt.manual_stepping_schedule([0.3, 0.6], [1e-3, 5e-4, 1e-4], 20)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6, atol=1e-7)


def test_safe_global_norm_and_clip():
    rs = np.random.RandomState(1)
    leaves = [rs.randn(7, 3).astype(np.float32) * 3e18, rs.randn(5).astype(np.float32)]
    nj = float(jopt.safe_global_norm([jnp.asarray(x) for x in leaves]))
    ts = [torch.from_numpy(x.copy()) for x in leaves]
    nt = float(topt.safe_clip_by_global_norm(ts, 10.0))
    assert np.isfinite(nt) and abs(nt - nj) <= 1e-6 * nj  # plain f32 sums overflow here
    np.testing.assert_allclose(float(topt.safe_global_norm(ts)), 10.0, rtol=1e-5)
    leaves[1][2] = np.inf
    assert not np.isfinite(float(topt.safe_global_norm([torch.from_numpy(x) for x in leaves])))
