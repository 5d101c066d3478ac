"""Three train steps in both packages from the same weights on the same
batch (the `__graft_entry__._tiny_setup` training scene, B=2, f32, the
default `OptimizerConfig`): the port's `Trainer.run_step` against the JAX
package's train step (`train/loop.make_train_step` over
`train/optim.build_optimizer`, the function `Trainer.run_step` calls; the
JAX `Trainer` constructor's own eager init is replaced by the shared
params). The loss and grad_norm trajectories agree within rtol 1e-3 and
skipped_nonfinite agrees. Parameters are not compared after Adam: it
normalises near-zero gradients, so their signs decide whole-lr steps.

Then the port's non-finite guard: a batch whose loss is NaN changes
neither the parameters nor the optimizer state and reports
skipped_nonfinite = 1.
"""
import copy

import jax
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import _torch_port_train_common as T
from rnnpose_tpu.train import loop as jloop
from rnnpose_tpu.train import optim as jopt
from rnnpose_tpu_torch.train.loop import Trainer
from rnnpose_tpu_torch.train.optim import OptimizerConfig


@pytest.fixture(scope="module")
def runs():
    jmodel, params, inputs = T.jax_train_setup(batch_size=2, render_iters=2)
    tx = jopt.build_optimizer(jopt.OptimizerConfig(), params)
    step = jloop.make_train_step(jmodel, tx, donate=False)
    p, o = params, tx.init(params)
    jax_m = []
    for _ in range(3):
        p, o, m = step(p, o, inputs)
        jax_m.append({k: float(v) for k, v in m.items()})

    trainer = Trainer(T.port_model(jmodel, params), OptimizerConfig())
    batch = T.port_train_inputs(inputs)
    port_m = [{k: float(v) for k, v in trainer.run_step(batch).items()} for _ in range(3)]
    return jax_m, port_m, trainer, batch


def test_three_steps_match_jax(runs):
    jax_m, port_m, trainer, _ = runs
    assert trainer.state.step == 3 and trainer.state.optimizer.count == 3
    for k in ("loss", "grad_norm", "circle_loss", "flow_loss", "loss_3d_proj", "recall"):
        np.testing.assert_allclose([m[k] for m in port_m], [m[k] for m in jax_m],
                                   rtol=1e-3, err_msg=k)
    assert [m["skipped_nonfinite"] for m in port_m] == [m["skipped_nonfinite"] for m in jax_m]
    assert all(m["skipped_nonfinite"] == 0.0 for m in port_m)
    assert len({m["loss"] for m in port_m}) == 3  # the updates moved the loss


def test_nonfinite_step_is_skipped(runs):
    *_, trainer, batch = runs
    before = {k: v.clone() for k, v in trainer.state_dict()["model"].items()}
    opt_before = copy.deepcopy(trainer.state.optimizer.state_dict())  # it holds references
    count = trainer.state.optimizer.count
    bad = batch._replace(image=torch.full_like(batch.image, float("nan")))
    m = trainer.run_step(bad)
    assert float(m["skipped_nonfinite"]) == 1.0 and not np.isfinite(float(m["grad_norm"]))
    assert trainer.state.optimizer.count == count and trainer.state.step == 4
    for k, v in trainer.state_dict()["model"].items():
        assert torch.equal(v, before[k]), k
    for pid, st in trainer.state.optimizer.state_dict()["adam"]["state"].items():
        for name, val in st.items():
            assert torch.equal(val, opt_before["adam"]["state"][pid][name]), (pid, name)
