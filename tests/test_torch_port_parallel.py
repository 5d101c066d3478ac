"""The port's data-parallel layer (`rnnpose_tpu_torch/parallel/`) against
the JAX package, on the CPU with gloo processes (each group of processes
under its own wall-clock limit).

* `weighted_reduce_metrics` across 2 processes equals the JAX function on
  the union of the processes' summaries (rtol 1e-12): mixed key sets, and a
  rank with no summary at all (either rank), every rank the same result.
* `shard_batch` keeps JAX's `shard_batch` contract on the tiny scene: rank r
  gets device r's shard of JAX's 2-device mesh for every leaf whose leading
  dimension is the batch, the mesh whole; a batch that does not split stays
  whole.
* The training loss is a mean of per-sample losses (B=4 against the mean of
  the 4 single-sample losses, rtol 1e-4; the port's counterpart of
  `tests/test_parallel_equivalence.py::test_loss_decomposes_over_batch`),
  which is why averaging gradients over ranks gives the global batch's.
* `dryrun_multichip(2)` on the `_tiny_setup(batch_size=2, train=True,
  render_iters=1)` scene: its own check of the averaged gradient against
  the port's single-process B=2 gradient (cosine > 0.9999, norm ratio
  1 +- 1e-3, loss rtol 1e-3, parameters bitwise equal across the ranks),
  and the averaged gradient per parameter against `jax.grad` at B=2 at the
  bounds of `test_torch_port_train_model.py` (cosine > 0.999, norm within
  1%, float-noise leaves aside).
"""
import dataclasses
import json
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import _torch_port_train_common as T
from rnnpose_tpu.parallel.collectives import weighted_reduce_metrics as j_reduce
from rnnpose_tpu_torch.parallel import mesh

REDUCE_WORKER = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from rnnpose_tpu_torch.parallel import mesh
    from rnnpose_tpu_torch.parallel.collectives import weighted_reduce_metrics
    rank, addr, cases = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    mesh.init_distributed(addr, 2, rank, backend="gloo", device="cpu")
    out = [weighted_reduce_metrics(case[rank]) for case in cases]
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()  # a group left to the interpreter's exit may abort it
""")

# Per case: rank 0's and rank 1's summaries.
CASES = {
    "rank1_empty": [[{"add01": 1.0, "proj5": 0.5, "seq_len": 10},
                     {"add01": 0.2, "adds_auc": 0.7, "seq_len": 3}], []],
    "rank0_empty": [[], [{"add01": 0.1, "seq_len": 4}, {"adds_auc": 0.3, "seq_len": 6}]],
    "mixed_keys": [[{"add01": 1.0, "seq_len": 10}],
                   [{"add01": 0.0, "seq_len": 15}, {"add01": 0.4, "adds_auc": 0.9,
                                                    "seq_len": 5}]],
}


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    cases = list(CASES.values())
    outs = mesh.launch_local(
        lambda r, addr: [sys.executable, "-c", REDUCE_WORKER, str(r), addr, json.dumps(cases)],
        2, str(tmp_path_factory.mktemp("reduce")), 120, env={"OMP_NUM_THREADS": "1"})
    per_rank = [json.loads(o.split("RESULT ", 1)[1].splitlines()[0]) for o in outs]
    return {name: [per_rank[r][i] for r in range(2)] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_weighted_reduce_metrics_across_processes_matches_jax(reduced, case):
    want = j_reduce(CASES[case][0] + CASES[case][1])
    for got in reduced[case]:
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def _fields(port, jax_obj, path=""):
    """(path, port tensor, JAX leaf) over the port structure's fields."""
    if isinstance(port, torch.Tensor):
        yield path, port, jax_obj
    elif port is None:
        assert jax_obj is None, path
    elif isinstance(port, (list, tuple)) and not hasattr(port, "_fields"):
        for i, (a, b) in enumerate(zip(port, jax_obj, strict=True)):
            yield from _fields(a, b, f"{path}[{i}]")
    else:
        names = port._fields if hasattr(port, "_fields") else vars(port)
        for name in names:
            yield from _fields(getattr(port, name), getattr(jax_obj, name), f"{path}.{name}")


def test_shard_batch_keeps_the_jax_contract():
    from __graft_entry__ import _tiny_setup
    from rnnpose_tpu.parallel import mesh as jmesh

    _, inputs = _tiny_setup(batch_size=2, train=True, render_iters=1)
    port = T.port_train_inputs(inputs)
    jmesh_2 = jmesh.make_mesh(jax.devices("cpu")[:2])
    sharded = jmesh.shard_batch(inputs, jmesh_2, batch_size=2)
    leaves = list(_fields(port, sharded))
    split = 0
    for r, device in enumerate(jmesh_2.devices):
        mine = dict((p, t) for p, t, _ in _fields(mesh.shard_batch(port, 2, rank=r, world=2),
                                                   sharded))
        for path, whole, jleaf in leaves:
            want = next(s.data for s in jleaf.addressable_shards if s.device == device)
            np.testing.assert_array_equal(mine[path].numpy(), np.asarray(want), err_msg=path)
            split += mine[path].shape != whole.shape
    assert split == 2 * sum(t.shape[0] == 2 for _, t, _ in leaves if t.dim())
    assert all(mine[p] is t for p, t, _ in leaves if p.startswith(".mesh"))
    # A batch that does not split over the ranks, or one rank: unchanged.
    assert mesh.shard_batch(port, 2, rank=1, world=3) is port
    assert mesh.shard_batch(port, 2) is port  # no process group here


def test_loss_decomposes_over_batch():
    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_

    n = 4
    syn = SyntheticConfig(image_size=64, batch_size=n, num_verts=128, num_faces=256,
                          subdivisions=2, num_corr=64, kp_layers=2, kp_dl=0.02, fx=100.0,
                          fy=100.0)
    inputs = make_synthetic_inputs(syn, with_corr=True)
    kp = kpconv_config(syn)
    model = init_random_(RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(render_iters=2, gru_iters=1, zoom_crop_size=32, corr_levels=2,
                              raster_chunk=64, mixed_precision=False))),
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        full = float(model(inputs, train=True)["loss"])
        per_sample = [float(model(mesh.shard_batch(inputs, n, rank=i, world=n),
                                  train=True)["loss"]) for i in range(n)]
    np.testing.assert_allclose(full, np.mean(per_sample), rtol=1e-4)
    assert np.ptp(per_sample) > 1e-3 * abs(full)  # the samples differ


def test_dryrun_multichip_matches_single_process_and_jax():
    from rnnpose_tpu_torch.models.convert import flax_to_state_dict
    from rnnpose_tpu_torch.parallel.dryrun import dryrun_multichip

    jmodel, params, inputs = T.jax_train_setup(batch_size=2, render_iters=1)
    grads_j = flax_to_state_dict(jax.device_get(jax.jit(jax.grad(
        lambda p: jmodel.apply(p, inputs, train=True)["loss"]))(params)))
    res = dryrun_multichip(2, model=T.port_model(jmodel, params),
                           inputs=T.port_train_inputs(inputs), return_grads=True,
                           timeout_s=300)
    assert res["params_equal"] and res["batch"] == 2
    assert res["grad_cosine"] > 0.9999 and abs(res["grad_norm_ratio"] - 1) < 1e-3
    assert res["launches"] == [dict.fromkeys(res["launches"][0], 0)] * 2  # CPU: plain
    assert res["allreduce_bytes"] == 4 * res["num_params"]
    grads_t = {n: g.numpy() for n, g in res["grads"].items()}
    norms = {n: (np.linalg.norm(grads_j[n]), np.linalg.norm(g)) for n, g in grads_t.items()}
    top = max(max(v) for v in norms.values())
    checked = 0
    for n, (nj, nt) in norms.items():
        if max(nj, nt) < 1e-6 * top:
            assert n.endswith(".bias") or ".convP" in n, n
            continue
        cos = float(grads_j[n].ravel() @ grads_t[n].ravel() / (nj * nt + 1e-30))
        assert cos > 0.999, f"gradient direction diverges at {n}: {cos}"
        assert 0.99 < nt / nj < 1.01, f"gradient magnitude diverges at {n}: {nt / nj}"
        checked += 1
    assert checked > 0.8 * len(norms), (checked, len(norms))
    print(f"dryrun_multichip(2): cosine {res['grad_cosine']:.9f}, norm ratio "
          f"{res['grad_norm_ratio']:.9f}, loss vs the parts' mean {res['split_rel_err']:.3e}, "
          f"{checked} leaves held to jax.grad", file=sys.stderr)
