"""The CUDA raster kernels against their plain PyTorch versions on the card.

This file imports no jax (the card's machine has none), so the card runs it
on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`tests/conftest.py` imports jax; `--noconftest` skips it). Every test is
marked `cuda` and skips where `torch.cuda.is_available()` is false. The LM
step kernel's tests, at the end, state their own bound; the correlation
lookup kernel's, after them, hold it to its plain version bit for bit; the
instance norm kernel's hold it to `chip_smoke.norm_gap`'s bound; the 1D
lookup's and RAFT-Stereo's engine, last, hold them to their plain version
and eager forward bit for bit. The
scenes are those of the JAX-comparing raster tests, rebuilt with the port's
own `data/synthetic.make_icosphere` and `render/mesh.pad_mesh` (a test in
`test_torch_port_raster.py` holds them equal to the JAX package's): the
icosphere of subdivision 2, radius 6 cm, padded to 256 vertices and 1024
faces, at two poses. Bounds: face ids exact, z 1e-5, attrs 1e-4, one
launch counted per wrapper call.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (
    LM_TOL, LOOKUP_CASES, LOOKUP_SHAPES, NORM_SHAPES, STEREO_LOOKUP_CASES, STEREO_LOOKUP_SHAPES,
    corr_problem, lm_problem, norm_gap, norm_problem, output_tensors, same_bits,
    stereo_lookup_problem, stereo_model)
from rnnpose_tpu_torch import kernels
from rnnpose_tpu_torch.data.synthetic import make_icosphere
from rnnpose_tpu_torch.geometry import projective as tproj
from rnnpose_tpu_torch.kernels import corr as corr_kernel
from rnnpose_tpu_torch.kernels import lm as lm_kernel
from rnnpose_tpu_torch.kernels import norm as norm_kernel
from rnnpose_tpu_torch.kernels import raster as rk
from rnnpose_tpu_torch.render import mesh as tmesh
from rnnpose_tpu_torch.render import raster as traster

POSES = ((0.0, 0.0, 0.5), (0.08, -0.05, 0.65))

needs_card = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")


def icosphere_scene(offsets=POSES, K=(120.0, 120.0, 32.0, 32.0)):
    """verts (B, 256, 3), faces (1024, 3), K (B, 4), face_valid (1024,),
    attrs (B, 256, 6) seeded from 3."""
    m = tmesh.pad_mesh(make_icosphere(2, 0.06), 256, 1024)
    verts = (m.verts[None] + np.asarray(offsets, np.float32)[:, None, :]).astype(np.float32)
    K = np.tile(np.asarray([K], np.float32), (len(offsets), 1))
    attrs = np.random.RandomState(3).randn(len(offsets), 256, 6).astype(np.float32)
    return verts, m.faces, K, np.arange(1024) < m.num_faces, attrs


def pack(verts, faces, K, fv, attrs):
    """face_data, bbox and the per-face corner attrs of the sweeps."""
    uv, _ = tproj.project(torch.from_numpy(verts), torch.from_numpy(K)[:, None, :])
    f = torch.from_numpy(faces.astype(np.int64))
    face_data, bbox = traster.prepare_face_data(
        uv, torch.from_numpy(verts[..., 2]), f, torch.from_numpy(fv))
    return face_data, bbox, torch.from_numpy(attrs)[:, f].contiguous()


def _assert_close(out, plain, n=None):
    (z, f, *a), (z_p, f_p, *a_p) = out, plain
    n = n or f.shape[0]
    assert torch.equal(f, f_p[:n])
    assert float((z - z_p[:n]).abs().max()) <= 1e-5
    if a:
        assert float((a[0] - a_p[0][:n]).abs().max()) <= 1e-4


@pytest.mark.cuda
@needs_card
def test_cuda_kernel_matches_plain_version_on_card():
    """The rows-attrs kernel against the plain version at the main path's
    240^2 / chunk 128 shapes (the 64^2 camera scaled to 240^2)."""
    verts, faces, K, fv, attrs = icosphere_scene()
    K = K * np.float32(240 / 64)
    fd, bb, ca = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    before = kernels.LAUNCHES["zbuffer_sweep_rows_attrs"]
    out_k = rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 240, 240, chunk=128)
    out_p = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 240, 240, chunk=128)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["zbuffer_sweep_rows_attrs"] == before + 1
    _assert_close(out_k, out_p)
    assert float((out_k[1] >= 0).float().mean()) > 0.02


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("size", [240, 232])
def test_cuda_kernels_match_plain_version_on_card(size):
    """The culled and brute-force z/fid kernels at 240^2 and 232^2 (partial
    edge tiles), chunk 128, B=2; then the brute-force kernel on the same
    rows with an eighth replaced by `chip_smoke.adversarial_faces`, its
    reach pass equal to `brute_reach_bbox_plain`."""
    import chip_smoke

    verts, faces, K, fv, attrs = icosphere_scene()
    K = K * np.float32(size / 64)
    fd, bb, _ = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    before = kernels.LAUNCHES["zbuffer_sweep_tiled"], kernels.LAUNCHES["zbuffer_sweep"]
    z_p, f_p = rk.zbuffer_sweep_tiled_plain(fd, bb, size, size, 128)
    for z_k, f_k in (rk.zbuffer_sweep_tiled(fd, bb, size, size, 128),
                     rk.zbuffer_sweep(fd, size, size, 128)):
        torch.cuda.synchronize()
        assert torch.equal(f_k, f_p)
        assert float((z_k - z_p).abs().max()) <= 1e-5
    assert (kernels.LAUNCHES["zbuffer_sweep_tiled"], kernels.LAUNCHES["zbuffer_sweep"]) == (
        before[0] + 1, before[1] + 1)
    adv = chip_smoke.adversarial_faces(fd, size, size, seed=size)
    z_p, f_p = rk.zbuffer_sweep_tiled_plain(adv, None, size, size, 128)
    z_k, f_k = rk.zbuffer_sweep(adv, size, size, 128)
    torch.cuda.synchronize()
    assert torch.equal(f_k, f_p)
    both = (f_k >= 0) & (f_p >= 0)
    assert float((z_k - z_p).abs()[both].max()) <= 1e-5
    assert torch.equal(rk._launch_reach(adv, size, size),
                       rk.brute_reach_bbox_plain(adv, size, size))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("tile", [16, 24, 40])
def test_cuda_tiled_attrs_kernels_match_plain_version_on_card(tile):
    """Both tiled-attrs kernels (per-(b, tile) grid and one mesh) at 240^2,
    chunk 128, B=2 and one mesh."""
    verts, faces, K, fv, attrs = icosphere_scene(K=(450.0, 450.0, 120.0, 120.0))
    fd, bb, ca = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    before = (kernels.LAUNCHES["zbuffer_sweep_tiled_attrs_batched"],
              kernels.LAUNCHES["zbuffer_sweep_tiled_attrs"])
    plain = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 240, 240, 128, tile)
    outs = [rk.zbuffer_sweep_tiled_attrs_batched(fd, bb, ca, 240, 240, 128, tile),
            [x[None] for x in rk.zbuffer_sweep_tiled_attrs(fd[0], bb[0], ca[0], 240, 240, 128,
                                                           tile)]]
    torch.cuda.synchronize()
    for out, n in zip(outs, (2, 1)):
        _assert_close(out, plain, n)
    assert (kernels.LAUNCHES["zbuffer_sweep_tiled_attrs_batched"],
            kernels.LAUNCHES["zbuffer_sweep_tiled_attrs"]) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("tile", [24, 40])
def test_cuda_culled_kernels_at_larger_tiles_on_card(tile):
    """The rows-attrs and culled z/fid kernels at a larger tile (240^2,
    B=2)."""
    verts, faces, K, fv, attrs = icosphere_scene(K=(450.0, 450.0, 120.0, 120.0))
    fd, bb, ca = (x.cuda() for x in pack(verts, faces, K, fv, attrs))
    plain = rk.zbuffer_sweep_rows_attrs_plain(fd, bb, ca, 240, 240, 128, tile)
    out = rk.zbuffer_sweep_rows_attrs(fd, bb, ca, 240, 240, 128, tile)
    out2 = rk.zbuffer_sweep_tiled(fd, bb, 240, 240, 128, tile)
    torch.cuda.synchronize()
    _assert_close(out, plain)
    _assert_close(out2, plain)


def _engine_scene(**refiner):
    """A tiny model on the card (the tests' 96^2 scene, 3-layer towers, the
    default bf16 refiner at 1 x 2 iterations, or as `refiner` overrides it)
    and its requests at B=1 and B=2, two per batch size (the second with
    another pose and image)."""
    import dataclasses

    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_

    syn = SyntheticConfig(image_size=96, num_verts=256, num_faces=512, subdivisions=2,
                          fx=150.0, fy=150.0, kp_layers=3, kp_dl=0.015)
    kp = kpconv_config(syn)
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(**dict(dict(zoom_crop_size=48, corr_levels=3, raster_chunk=64,
                                          render_iters=1, gru_iters=2), **refiner))))
    model = init_random_(model, torch.Generator().manual_seed(0)).cuda()
    requests = {}
    for B in (1, 2):
        x = make_synthetic_inputs(dataclasses.replace(syn, batch_size=B), device="cuda")
        requests[B] = [x, x._replace(T_init=x.T_gt, image=x.image.flip(1))]
    return model, requests


@pytest.mark.cuda
@needs_card
def test_engine_replay_equals_eager_on_card():
    """`InferenceEngine` captures one CUDA graph per class and shape (B=1
    and B=2); every output of each replayed request equals the eager cached
    forward's bit for bit, and the rows-attrs kernel launches from Python
    only in the warm-ups and the capture."""
    from rnnpose_tpu_torch.models.engine import WARMUP_RUNS, InferenceEngine

    model, requests = _engine_scene()
    engine = InferenceEngine(model)
    for B, reqs in requests.items():
        before = kernels.LAUNCHES["zbuffer_sweep_rows_attrs"]
        outs = [engine.refine(f"ico_b{B}", r) for r in reqs]
        assert kernels.LAUNCHES["zbuffer_sweep_rows_attrs"] == before + WARMUP_RUNS + 1
        d3, c3 = engine.class_features(f"ico_b{B}", None)
        for r, out in zip(reqs, outs):
            eager = output_tensors(model(r, cached_desc3d=d3, cached_ctx3d=c3))
            got = output_tensors(out)
            assert got.keys() == eager.keys() and len(got) > 10
            for k in got:
                assert torch.equal(got[k], eager[k]), (B, k)
        assert not torch.equal(outs[0]["Ti_pred"], outs[1]["Ti_pred"])
    assert engine.graph_captures == len(requests)


@pytest.mark.cuda
@needs_card
def test_engine_capture_with_a_host_read_raises(monkeypatch):
    """A host read in the forward (`.item()` before each LM step) fails the
    capture, and the engine raises instead of running the eager forward."""
    from types import SimpleNamespace

    from rnnpose_tpu_torch.geometry import lm
    from rnnpose_tpu_torch.models.engine import InferenceEngine

    model, requests = _engine_scene()

    def reading_step(T, *args):
        T.sum().item()
        return lm_kernel.lm_step(T, *args)

    monkeypatch.setattr(lm, "lm_kernel", SimpleNamespace(lm_step=reading_step))
    engine = InferenceEngine(model)
    with pytest.raises(RuntimeError):
        engine.refine("ico", requests[1][0])
    assert engine.graph_captures == 0 and not engine._programs


def _train_scene(seed=0):
    """The engine tests' tiny model, in f32 for training, on the card, and
    a training batch of its scene at B=2 (with the correspondence set)."""
    import dataclasses

    from rnnpose_tpu_torch.data.synthetic import (
        SyntheticConfig, kpconv_config, make_synthetic_inputs)
    from rnnpose_tpu_torch.models.refiner import RefinerConfig
    from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_

    syn = SyntheticConfig(image_size=96, num_verts=256, num_faces=512, subdivisions=2,
                          fx=150.0, fy=150.0, kp_layers=3, kp_dl=0.015, batch_size=2,
                          num_corr=64)
    kp = kpconv_config(syn)
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(zoom_crop_size=48, corr_levels=3, raster_chunk=64,
                              render_iters=1, gru_iters=2, mixed_precision=False)))
    model = init_random_(model, torch.Generator().manual_seed(seed)).cuda()
    return model, make_synthetic_inputs(syn, device="cuda", with_corr=True)


def _moved(batch, k):
    """The batch with another initial pose and image noise (seeded by k)."""
    from rnnpose_tpu_torch.geometry.se3 import se3_expm

    gen = torch.Generator().manual_seed(k)
    B = batch.image.shape[0]
    return batch._replace(
        T_init=se3_expm(torch.randn(B, 6, generator=gen) * 1e-3).cuda() @ batch.T_init,
        image=(batch.image + 0.02 * torch.rand(batch.image.shape, generator=gen).cuda())
        .clamp(0.0, 1.0))


@pytest.mark.cuda
@needs_card
def test_trainer_replay_equals_eager_on_card(monkeypatch):
    """`Trainer`'s graphs against `make_train_step` on a deep copy of the
    model, under deterministic algorithms: WARMUP_RUNS eager steps, the
    capturing step and two replays on distinct batches, then a NaN batch.
    Every metric of every step, and every parameter, moment and the update
    count after each, bit for bit; the NaN step skipped by both with the
    state unchanged; the rows-attrs kernel launched from Python in the
    warm-ups and the capture only."""
    import copy
    import os

    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS, Trainer, make_train_step
    from rnnpose_tpu_torch.train.optim import OptimizerConfig, build_optimizer

    # cuBLAS is deterministic only with a fixed workspace (chip_smoke.py sets
    # it before the first handle; run alone, set it in the environment).
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG",
                       os.environ.get("CUBLAS_WORKSPACE_CONFIG", ":4096:8"))
    model, batch = _train_scene()
    twin = copy.deepcopy(model)
    trainer = Trainer(model, OptimizerConfig())
    opt = build_optimizer(OptimizerConfig(), twin)
    eager = make_train_step(twin, opt)
    R = model.cfg.refiner.render_iters

    def state(m, o):
        return ([p.detach().clone() for p in m.parameters()] + [x.clone() for x in o.m]
                + [x.clone() for x in o.v] + [o.count.clone()])

    torch.use_deterministic_algorithms(True)
    try:
        batches = [_moved(batch, k) for k in range(WARMUP_RUNS + 3)]
        for i, b in enumerate(batches):
            before = kernels.LAUNCHES["zbuffer_sweep_rows_attrs"]
            got, want = trainer.run_step(b), eager(b)
            launched = kernels.LAUNCHES["zbuffer_sweep_rows_attrs"] - before
            assert launched == (2 * R if i <= WARMUP_RUNS else R), i  # eager's R always
            assert got.keys() == want.keys()
            for k in got:
                assert torch.equal(got[k], want[k]), (i, k)
            for x, y in zip(state(model, trainer.state.optimizer), state(twin, opt)):
                assert torch.equal(x, y), i
        assert trainer.graph_captures == 1 and int(opt.count) == len(batches)
        kept = state(twin, opt)
        bad = batch._replace(image=torch.full_like(batch.image, float("nan")))
        got, want = trainer.run_step(bad), eager(bad)
        assert float(got["skipped_nonfinite"]) == float(want["skipped_nonfinite"]) == 1.0
        for x, y, z in zip(state(model, trainer.state.optimizer), state(twin, opt), kept):
            assert torch.equal(x, z) and torch.equal(y, z)
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
@needs_card
def test_trainer_replay_launches_no_kernel_from_python(tmp_path):
    """One replayed training step under torch.profiler: no kernel-launch
    API call, two graph launches (A: forward and backward; B: the update),
    and the rows-attrs kernel's render_iters device events inside them."""
    from chip_smoke import _traced
    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS, Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    model, batch = _train_scene()
    trainer = Trainer(model, OptimizerConfig())
    for k in range(WARMUP_RUNS + 1):
        trainer.run_step(_moved(batch, k))
    b = _moved(batch, 9)
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["zbuffer_sweep_rows_attrs"]
    agg, sweeps, graphs = _traced(lambda: trainer.run_step(b), str(tmp_path))
    assert kernels.LAUNCHES["zbuffer_sweep_rows_attrs"] == before
    assert agg["launches"] == 0 and graphs == 2
    assert sweeps == {"attrs": model.cfg.refiner.render_iters}


@pytest.mark.cuda
@needs_card
def test_trainer_capture_with_a_host_read_raises(monkeypatch):
    """A host read in the loss (`.item()` in the circle loss) runs in the
    eager warm-up steps, then fails the capture: the trainer raises, makes
    no graph, and the next step raises again instead of running eagerly."""
    from rnnpose_tpu_torch.train import losses
    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS, Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig

    model, batch = _train_scene()
    circle = losses.circle_loss

    def reading_circle_loss(*args, **kwargs):
        out = circle(*args, **kwargs)
        out.sum().item()
        return out

    monkeypatch.setattr(losses, "circle_loss", reading_circle_loss)
    trainer = Trainer(model, OptimizerConfig())
    for _ in range(WARMUP_RUNS):
        trainer.run_step(batch)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            trainer.run_step(batch)
    assert trainer.graph_captures == 0 and trainer.state.step == WARMUP_RUNS


def _forward_stages(R, G):
    return ["encode"] + R * (["render", "encode"] + G * ["flow", "pose"]) + ["tail"]


@pytest.mark.cuda
@needs_card
def test_traced_engine_graph_adds_one_node_per_mark_on_card():
    """A traced engine's graph holds the untraced one's nodes plus one stamp
    node per mark and gives the same bits; a replayed request's stamps are
    the copy-in, the forward's stages in order and the clones, and the
    stages' device times sum to the replay's first stamp to its last."""
    from rnnpose_tpu_torch.models.engine import InferenceEngine
    from rnnpose_tpu_torch.utils import profiling
    from rnnpose_tpu_torch.utils.profiling import END

    model, requests = _engine_scene()
    plain = InferenceEngine(model)
    tracer = profiling.Tracer(torch.device("cuda", 0))
    traced = InferenceEngine(model, tracer=tracer)
    for r in requests[1]:
        a, b = output_tensors(plain.refine("ico", r)), output_tensors(traced.refine("ico", r))
        assert a.keys() == b.keys() and len(a) > 10
        assert all(torch.equal(a[k], b[k]) for k in a)
    doc = tracer.export()
    assert doc["stamps_mismatched"] == doc["stamps_dropped"] == 0
    assert doc["stamps_launched"] == doc["stamps_expected"]
    forward = _forward_stages(model.cfg.refiner.render_iters, model.cfg.refiner.gru_iters)
    call = doc["calls"][-1]
    stamps = [s for s in doc["stamps"] if s["call"] == call["id"]]
    assert [s["name"] for s in stamps] == ["copy_in", END] + forward + [END, "clone_out", END]
    marks = sum(s["replay"] for s in stamps)
    assert marks == len(forward) + 1
    label, = plain.graph_nodes
    assert traced.graph_nodes[label] == plain.graph_nodes[label] + marks
    ms = profiling.stage_ms(doc, [call["id"]])
    assert sum(ms[n][0] for n in set(forward)) == pytest.approx(call["replay_ns"] / 1e6,
                                                                rel=1e-9)
    assert dict(traced.replays) == dict(plain.replays) == {label: 2}


@pytest.mark.cuda
@needs_card
def test_traced_trainer_graphs_add_one_node_per_mark_on_card(monkeypatch):
    """Under deterministic algorithms a traced trainer's steps (warm-ups,
    capture, replays) equal an untraced trainer's on a copy of the model,
    bit for bit; its graphs A and B hold the untraced ones' nodes plus one
    per mark; a replayed step's stamps nest the forward's stages in
    `forward`."""
    import copy
    import os

    from rnnpose_tpu_torch.train.loop import WARMUP_RUNS, Trainer
    from rnnpose_tpu_torch.train.optim import OptimizerConfig
    from rnnpose_tpu_torch.utils import profiling
    from rnnpose_tpu_torch.utils.profiling import END

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG",
                       os.environ.get("CUBLAS_WORKSPACE_CONFIG", ":4096:8"))
    model, batch = _train_scene()
    twin = copy.deepcopy(model)
    plain = Trainer(model, OptimizerConfig())
    tracer = profiling.Tracer(torch.device("cuda", 0))
    traced = Trainer(twin, OptimizerConfig(), tracer=tracer)
    torch.use_deterministic_algorithms(True)
    try:
        for k in range(WARMUP_RUNS + 3):
            b = _moved(batch, k)
            got, want = traced.run_step(b), plain.run_step(b)
            for key in got:
                assert torch.equal(got[key], want[key]), (k, key)
        for p, q in zip(twin.parameters(), model.parameters()):
            assert torch.equal(p, q)
    finally:
        torch.use_deterministic_algorithms(False)
    doc = tracer.export()
    assert doc["stamps_mismatched"] == doc["stamps_dropped"] == 0
    forward = _forward_stages(model.cfg.refiner.render_iters, model.cfg.refiner.gru_iters)
    call = doc["calls"][-1]
    stamps = [s for s in doc["stamps"] if s["call"] == call["id"]]
    assert [s["name"] for s in stamps] == (["copy_in", END, "forward"] + forward
                                           + ["backward", END, "update", END, "clone_out", END])
    label, = plain.graph_nodes
    marks = sum(s["replay"] for s in stamps)
    assert sum(traced.graph_nodes[label]) == sum(plain.graph_nodes[label]) + marks
    groups = profiling.group_ms(doc, ("forward", "backward", "update"), [call["id"]])
    assert all(v[0] > 0 for v in groups.values())


# The LM step kernel (`csrc/lm_step.cu`) against its plain version on the
# card, on `chip_smoke.lm_problem`'s inputs. Bound: `chip_smoke.LM_TOL`,
# 1e-6 on each entry of the new pose, a few f32 ulps: the two differ only in
# rounding (cuBLAS's fused products and f64 sum order against the kernel's;
# the reason in full beside LM_TOL).


def _lm_twist(T_new, T):
    from rnnpose_tpu_torch.geometry import se3

    return se3.se3_logm(T_new @ se3.se3_inverse(T))


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("B,size", [(1, 30), (8, 30), (8, 240)])
def test_lm_kernel_matches_plain_version_on_card(B, size):
    """One launch per call; the new pose within LM_TOL of the plain
    version's on the card; an item with no weight or a non-finite one keeps
    its pose exactly; the steps move the poses."""
    T, target, weight, depth, K = lm_problem(B, size, seed=B * 1000 + size)
    before = kernels.LAUNCHES["lm_step"]
    got = lm_kernel.lm_step(T, target, weight, depth, K)
    want = lm_kernel.lm_step_plain(T, target, weight, depth, K)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lm_step"] == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= LM_TOL
    moved = _lm_twist(got, T).abs().amax(-1)
    if B >= 4:
        assert torch.equal(got[2], T[2]) and torch.equal(want[2], T[2])
        assert torch.equal(got[3], T[3]) and torch.equal(want[3], T[3])
        moved = moved[[0, 1] + list(range(4, B))]
    assert float(moved.min()) > 1e-5


@pytest.mark.cuda
@needs_card
def test_lm_kernel_clamp_on_card():
    """Targets 300 px off and weak damping: every twist saturates the clamp
    in both versions, and the poses agree within LM_TOL."""
    T, target, weight, depth, K = lm_problem(3, 30, seed=7)
    args = (T, target + 300.0, weight, depth, K, 1e-4, 1e-3, 0.05, 0.1)
    got, want = lm_kernel.lm_step(*args), lm_kernel.lm_step_plain(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= LM_TOL
    assert float(_lm_twist(got, T).abs().amax(-1).min()) == pytest.approx(0.05, rel=1e-3)


@pytest.mark.cuda
@needs_card
def test_lm_kernel_repeats_bit_for_bit_on_card():
    """No floating-point atomics and no state kept between launches: two
    calls give the same bits, so do two launches running at once on two
    streams, and so do three replays of a graph that captured one launch;
    the capture counts one launch, the replays none."""
    T, target, weight, depth, K = lm_problem(8, 240, seed=11)
    first = lm_kernel.lm_step(T, target, weight, depth, K)
    second = lm_kernel.lm_step(T, target, weight, depth, K)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(lm_kernel.lm_step(T, target, weight, depth, K))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lm_kernel.lm_step(T, target, weight, depth, K)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernels.LAUNCHES["lm_step"]
    with torch.cuda.graph(graph):
        out = lm_kernel.lm_step(T, target, weight, depth, K)
    assert kernels.LAUNCHES["lm_step"] == before + 1
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert kernels.LAUNCHES["lm_step"] == before + 1


@pytest.mark.cuda
@needs_card
def test_engine_graph_holds_one_node_per_lm_step_on_card(monkeypatch):
    """The engine's graph with the kernel holds k - 1 fewer nodes per LM
    step than with the step as a chain of PyTorch ops (k: the chain's nodes,
    captured alone on inputs of the same layout), counts one LM launch per
    step in its capture, and refines to within 1e-4 of the chain's pose
    (LM_TOL's rounding, carried through the scene's two LM steps)."""
    from types import SimpleNamespace

    from rnnpose_tpu_torch.geometry import lm
    from rnnpose_tpu_torch.geometry import projective as proj
    from rnnpose_tpu_torch.models.engine import InferenceEngine
    from rnnpose_tpu_torch.utils import profiling

    model, requests = _engine_scene()
    cfg = model.cfg.refiner
    steps = cfg.render_iters * cfg.gru_iters * cfg.optim_iters
    fused = InferenceEngine(model)
    got = fused.refine("ico", requests[1][0])["Ti_pred"]
    label, = fused.graph_nodes
    assert fused.counters()["kernel_launches"]["lm_step"] == {label: steps}

    layouts = []

    def chain(T, target, weight, depth, K, *constants):
        """The step as `reprojection_optim` ran it without the kernel."""
        layouts.append([(tuple(t.shape), t.stride()) for t in (T, target, weight, depth, K)])
        c = lm.LMConfig(*constants)
        X0 = proj.backproject(depth, K)
        return lm._lm_step(T, target, weight, X0, (depth > c.min_depth).to(depth.dtype), K, c)

    monkeypatch.setattr(lm, "lm_kernel", SimpleNamespace(lm_step=chain))
    plain = InferenceEngine(model)
    want = plain.refine("ico", requests[1][0])["Ti_pred"]
    assert plain.counters()["kernel_launches"]["lm_step"] == {label: 0}
    assert float((got - want).abs().max()) <= 1e-4

    args = [(torch.rand(1 + sum((n - 1) * st for n, st in zip(*lay)), device="cuda") + 0.5)
            .as_strided(*lay) for lay in layouts[-1]]
    constants = (1e-4, 100.0, 1.0, 0.1)
    chain(*args, *constants)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        chain(*args, *constants)
    k = profiling.graph_nodes(graph)
    assert k > 100
    assert plain.graph_nodes[label] - fused.graph_nodes[label] == steps * (k - 1)


def _raft_sintel():
    """The port's RAFT in the `raft-sintel` configuration's precision (bf16
    convolutions) with the benchmark's seeded weights, on the card, and two
    seeded 436 x 1024 pairs."""
    from benchmark.gen_flow import make_pairs, make_weights
    from rnnpose_tpu_torch.models.raft_flow import RAFT, RAFTConfig

    model = RAFT(RAFTConfig(mixed_precision=True)).cuda().eval()
    model.load_state_dict(make_weights(model, 22, "cuda"), strict=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    return model, [make_pairs(1, 436, 1024, 16, 2.0, gen)[:2] for _ in range(2)]


@pytest.mark.cuda
@needs_card
def test_flow_engine_replay_equals_eager_at_sintel_shape_on_card():
    """RAFT through `FlowEngine` at Sintel's evaluation shape (436 x 1024
    frames padded to 440 x 1024, 32 iterations): both replayed requests
    equal the eager forward bit for bit and the second makes no capture;
    a traced engine's graph holds the untraced one's nodes plus one stamp
    node per mark (encode, corr, 32 x lookup and update, upsample, end),
    gives the same bits, and its stages sum to the replay."""
    from rnnpose_tpu_torch.models.engine import FlowEngine
    from rnnpose_tpu_torch.utils import profiling
    from rnnpose_tpu_torch.utils.profiling import END

    model, pairs = _raft_sintel()
    engine = FlowEngine(model)
    outs = [engine.flow(*p, 32) for p in pairs]
    label, = engine.graph_nodes
    assert engine.graph_captures == 1 and dict(engine.replays) == {label: 2}
    with torch.no_grad():
        for p, out in zip(pairs, outs):
            eager = model(*p, 32)
            assert out.flow.shape == (1, 436, 1024, 2)
            assert out.flow_history.shape == (32, 1, 55, 128, 2)
            assert torch.equal(out.flow, eager.flow)
            assert torch.equal(out.flow_history, eager.flow_history)
    assert not torch.equal(outs[0].flow, outs[1].flow)
    counters = engine.counters()
    assert counters["flow_iters"] == {label: 32}
    assert counters["corr_pyramid_bytes"] == {label: 4 * 7040 * (7040 + 27 * 64 + 13 * 32 + 6 * 16)}

    tracer = profiling.Tracer(torch.device("cuda", 0))
    traced = FlowEngine(model, tracer=tracer)
    for p, out in zip(pairs, outs):
        got = traced.flow(*p, 32)
        assert torch.equal(got.flow, out.flow)
        assert torch.equal(got.flow_history, out.flow_history)
    doc = tracer.export()
    assert doc["stamps_mismatched"] == doc["stamps_dropped"] == 0
    assert doc["stamps_launched"] == doc["stamps_expected"]
    forward = ["encode", "corr"] + 32 * ["lookup", "update"] + ["upsample"]
    call = doc["calls"][-1]
    stamps = [s for s in doc["stamps"] if s["call"] == call["id"]]
    assert [s["name"] for s in stamps] == ["copy_in", END] + forward + [END, "clone_out", END]
    marks = sum(s["replay"] for s in stamps)
    assert marks == len(forward) + 1
    assert traced.graph_nodes[label] == engine.graph_nodes[label] + marks
    ms = profiling.stage_ms(doc, [call["id"]])
    assert sum(ms[n][0] for n in set(forward)) == pytest.approx(call["replay_ns"] / 1e6,
                                                                rel=1e-9)


@pytest.mark.cuda
@needs_card
def test_graphs_replayed_out_of_capture_order_on_card():
    """Three classes' RNNPose graphs captured in one order and replayed in
    another, and RAFT's graphs at two frame sizes on the same engine core,
    each replay equal to the eager forward bit for bit."""
    from rnnpose_tpu_torch.geometry.se3 import se3_expm
    from rnnpose_tpu_torch.models.engine import FlowEngine, InferenceEngine

    model, requests = _engine_scene()
    engine = InferenceEngine(model)
    names = ["a", "b", "c"]
    base = requests[1][0]
    gen = torch.Generator().manual_seed(3)

    def moved():
        xi = (torch.randn(1, 6, generator=gen) * 1e-3).cuda()
        return base._replace(T_init=se3_expm(xi) @ base.T_init)

    for n in names:
        engine.prepare(n, moved())
    assert engine.graph_captures == 3
    for n in ["c", "a", "b", "b", "c", "a"]:
        r = moved()
        got = output_tensors(engine.refine(n, r))
        d3, c3 = engine.class_features(n, None)
        eager = output_tensors(model(r, cached_desc3d=d3, cached_ctx3d=c3))
        assert got.keys() == eager.keys() and all(torch.equal(got[k], eager[k]) for k in got)
    assert engine.graph_captures == 3

    raft, pairs = _raft_sintel()
    flows = FlowEngine(raft)
    small = [p[:, :200, :300].contiguous() for p in pairs[0]]
    for p in (pairs[0], small, pairs[1], small):
        got = flows.flow(*p, 3)
        with torch.no_grad():
            eager = raft(*p, 3)
        assert torch.equal(got.flow, eager.flow)
        assert torch.equal(got.flow_history, eager.flow_history)
    assert flows.graph_captures == 2


# The correlation lookup kernel (`csrc/corr_lookup.cu`) against its plain
# version on the card, on `chip_smoke.corr_problem`'s inputs: bit for bit
# (`same_bits`: NaN where NaN), since both round the same f32 ops one by one.


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("B,H,W", LOOKUP_SHAPES + ((1, 4, 4),))
def test_corr_lookup_kernel_matches_plain_version_on_card(B, H, W):
    """At the serving, parity and RAFT grids (and a 4 x 4 grid, whose level
    3 is pooled away), 4 levels of radius 4, on every case (in-range,
    out-of-range, NaN and inf coordinates, non-finite level values, bf16
    levels) and on coords read through strides: one launch per call, the
    plain chain's bits."""

    for i, case in enumerate(LOOKUP_CASES):
        lv, coords = corr_problem(B, H, W, case, seed=B * 100 + H + i)
        before = kernels.LAUNCHES["corr_lookup"]
        got = corr_kernel.corr_lookup(lv, coords, 4)
        want = corr_kernel.corr_lookup_plain(lv, coords, 4)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["corr_lookup"] == before + 1
        assert got.dtype == torch.float32 and got.shape == (B, H, W, 4 * 81)
        assert same_bits(got, want), case
        # The same coords as views: rows 4 floats apart, channels planes apart.
        for view in (torch.cat([coords + 7.0, coords], -1)[..., 2:],
                     coords.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)):
            assert same_bits(view, coords) and not view.is_contiguous()
            assert same_bits(corr_kernel.corr_lookup(lv, view, 4), want), case
    if H == 4:
        assert lv[3].numel() == 0 and not got[..., 3 * 81:].any()


@pytest.mark.cuda
@needs_card
def test_corr_lookup_kernel_repeats_bit_for_bit_on_card():
    """No atomics and no state kept between launches, at RAFT's grid: two
    calls give the same bits, so do launches running at once on two
    streams, and so do three replays of a graph that captured one launch;
    the capture counts one launch, the replays none."""

    lv, coords = corr_problem(1, 55, 128, "nan_coords", seed=23)
    first = corr_kernel.corr_lookup(lv, coords, 4)
    second = corr_kernel.corr_lookup(lv, coords, 4)
    torch.cuda.synchronize()
    assert same_bits(first, second)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(corr_kernel.corr_lookup(lv, coords, 4))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    assert all(same_bits(o, first) for o in outs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        corr_kernel.corr_lookup(lv, coords, 4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernels.LAUNCHES["corr_lookup"]
    with torch.cuda.graph(graph):
        out = corr_kernel.corr_lookup(lv, coords, 4)
    assert kernels.LAUNCHES["corr_lookup"] == before + 1
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert same_bits(out, first)
    assert kernels.LAUNCHES["corr_lookup"] == before + 1


def _chain_lookups(monkeypatch):
    """`ops/corr.corr_lookup` as it ran without the kernel: the plain chain
    on every path."""
    from types import SimpleNamespace

    from rnnpose_tpu_torch.ops import corr

    plain = corr_kernel.corr_lookup_plain
    monkeypatch.setattr(corr, "corr_kernel", SimpleNamespace(corr_lookup=plain,
                                                             corr_lookup_plain=plain))


@pytest.mark.cuda
@needs_card
def test_engine_graph_loses_256_nodes_per_lookup_on_card(monkeypatch):
    """RNNPose at the refiner's 3 x 4 iterations and 4 correlation levels:
    the engine's graph with the kernel holds 256 nodes fewer per lookup than
    with the chain of PyTorch ops (257 kernels), counts 12 lookup launches
    in its capture (the chain's engine 0) beside 3 rows-attrs, 12 LM and 48
    instance norm launches (15 a render iteration and SuperPoint's 3) and
    none of the other operators, and gives the chain's outputs bit for
    bit."""
    from rnnpose_tpu_torch.models.engine import InferenceEngine

    model, requests = _engine_scene(zoom_crop_size=64, corr_levels=4, render_iters=3,
                                    gru_iters=4)
    fused = InferenceEngine(model)
    got = output_tensors(fused.refine("ico", requests[1][0]))
    label, = fused.graph_nodes
    assert fused.counters()["kernel_launches"] == dict(
        {op: {label: 0} for op in kernels.OPERATORS}, zbuffer_sweep_rows_attrs={label: 3},
        lm_step={label: 12}, corr_lookup={label: 12}, instance_norm={label: 48})
    _chain_lookups(monkeypatch)
    plain = InferenceEngine(model)
    want = output_tensors(plain.refine("ico", requests[1][0]))
    assert plain.counters()["kernel_launches"]["corr_lookup"] == {label: 0}
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    assert plain.graph_nodes[label] - fused.graph_nodes[label] == 12 * 256


@pytest.mark.cuda
@needs_card
def test_flow_engine_graph_loses_256_nodes_per_lookup_on_card(monkeypatch):
    """RAFT at Sintel's shape, 32 iterations: the graph with the kernel
    holds 32 x 256 nodes fewer than with the chain, counts 32 lookup
    launches in its capture (the chain's 0) beside `fnet`'s 15 instance
    norms, and gives the chain's flows bit for bit."""
    from rnnpose_tpu_torch.models.engine import FlowEngine

    model, pairs = _raft_sintel()
    fused = FlowEngine(model)
    got = fused.flow(*pairs[0], 32)
    label, = fused.graph_nodes
    assert fused.counters()["kernel_launches"]["corr_lookup"] == {label: 32}
    assert fused.counters()["kernel_launches"]["instance_norm"] == {label: 15}
    _chain_lookups(monkeypatch)
    plain = FlowEngine(model)
    want = plain.flow(*pairs[0], 32)
    assert plain.counters()["kernel_launches"]["corr_lookup"] == {label: 0}
    assert torch.equal(got.flow, want.flow)
    assert torch.equal(got.flow_history, want.flow_history)
    assert plain.graph_nodes[label] - fused.graph_nodes[label] == 32 * 256


# The instance norm kernel (`csrc/instance_norm.cu`) against its plain
# version on the card, at `chip_smoke.NORM_SHAPES` on `norm_problem`'s
# inputs: within `norm_gap`'s bound (f32: 1e-5; bf16: one bf16 ulp of the
# plain chain's value more), since both take the statistics in f32 in
# different orders.


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("name", sorted(NORM_SHAPES))
def test_instance_norm_kernel_matches_plain_version_on_card(name):
    """At every plane the cells run (the RNNPose encoders at B=2 and B=16,
    bf16 and f32, SuperPoint's tails, RAFT's `fnet`, RAFT-Stereo's `fnet` at
    Middlebury's 2016 x 2880, all three in the second mode), one more plane in the
    second mode (as RAFT's stem and parity's 320^2 tail), NCHW and an odd
    channel count, with and without the ReLU: one launch per call, the
    input's dtype and strides, within the bound."""
    x = norm_problem(name, seed=sorted(NORM_SHAPES).index(name))
    for relu in (False, True):
        before = kernels.LAUNCHES["instance_norm"]
        got = norm_kernel.instance_norm(x, 1e-5, relu)
        want = norm_kernel.instance_norm_plain(x, 1e-5, relu)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["instance_norm"] == before + 1
        assert got.dtype == x.dtype and got.stride() == x.stride()
        gap, differing, ok = norm_gap(got, want)
        assert ok, (relu, gap, differing)
    sms = kernels.build.sm_count(x.device.index)
    second_mode = name in ("second_mode", "raft_220x512", "superpoint_b8_320_f32",
                           "stereo_2016x2880", "stereo_1008x1440", "stereo_504x720")
    assert norm_kernel.launch_params(x, sms)["cached"] == int(not second_mode)


@pytest.mark.cuda
@needs_card
def test_instance_norm_kernel_repeats_bit_for_bit_on_card():
    """No atomics and no state kept between launches, on chip (RAFT's
    second plane) and in the second mode (its stem): two calls give the
    same bits, and so do three replays of a graph that captured one launch;
    the capture counts one launch, the replays none."""
    for name in ("raft_110x256", "raft_220x512"):
        x = norm_problem(name, seed=25)
        first = norm_kernel.instance_norm(x, 1e-5, True)
        second = norm_kernel.instance_norm(x, 1e-5, True)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            norm_kernel.instance_norm(x, 1e-5, True)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernels.LAUNCHES["instance_norm"]
        with torch.cuda.graph(graph):
            out = norm_kernel.instance_norm(x, 1e-5, True)
        assert kernels.LAUNCHES["instance_norm"] == before + 1
        for _ in range(3):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        assert kernels.LAUNCHES["instance_norm"] == before + 1


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("B,H,W", STEREO_LOOKUP_SHAPES)
def test_corr_lookup_1d_kernel_matches_plain_version_on_card(B, H, W):
    """At Middlebury's 504 x 720 grid (362,880 queries, level widths 720,
    360, 180, 90) and at a small grid at B=2, 4 levels of radius 4, on every
    case (in-range, out-of-range, NaN and inf coordinates, bf16 levels) and
    on coords read through strides: one launch per call, the plain chain's
    bits."""
    for i, case in enumerate(STEREO_LOOKUP_CASES):
        lv, coords = stereo_lookup_problem(B, H, W, case, seed=B * 100 + H + i)
        before = kernels.LAUNCHES["corr_lookup_1d"]
        got = corr_kernel.corr_lookup_1d(lv, coords, 4)
        want = corr_kernel.corr_lookup_1d_plain(lv, coords, 4)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["corr_lookup_1d"] == before + 1
        assert got.dtype == torch.float32 and got.shape == (B, H, W, 4 * 9)
        assert same_bits(got, want), case
        view = torch.cat([coords + 7.0, coords], -1)[..., 2:]
        assert not view.is_contiguous()
        assert same_bits(corr_kernel.corr_lookup_1d(lv, view, 4), want), case


@pytest.mark.cuda
@needs_card
def test_stereo_engine_graph_holds_one_node_per_lookup_on_card():
    """RAFT-Stereo (bf16) through `FlowEngine` at 300 x 560 frames (padded
    to 320 x 576), 32 iterations: the capture launches `corr_lookup_1d` 32 times and
    `instance_norm` 15 (one graph node each); two replays equal the eager
    forward bit for bit; a traced engine's graph holds the untraced one's
    nodes plus one stamp node per mark (encode, corr, 32 x lookup,
    coarse_gru and update, upsample, end) and gives the same bits."""
    from benchmark.gen_stereo import make_pairs
    from rnnpose_tpu_torch.models.engine import FlowEngine
    from rnnpose_tpu_torch.utils import profiling
    from rnnpose_tpu_torch.utils.profiling import END

    model = stereo_model(26)
    gen = torch.Generator(device="cuda").manual_seed(26)
    pairs = [make_pairs(1, 300, 560, 64, 2.0, gen)[:2] for _ in range(2)]
    engine = FlowEngine(model)
    outs = [engine.flow(*p, 32) for p in pairs]
    label, = engine.graph_nodes
    launches = {op: n[label] for op, n in engine.counters()["kernel_launches"].items()}
    assert launches == dict(dict.fromkeys(kernels.OPERATORS, 0), corr_lookup_1d=32,
                            instance_norm=15)
    assert engine.counters()["corr_pyramid_bytes"] == {label: 4 * 80 * 144 * (144 + 72 + 36 + 18)}
    with torch.no_grad():
        for p, out in zip(pairs, outs):
            eager = model(*p, 32)
            assert out.flow.shape == (1, 300, 560, 1)
            assert out.flow_history.shape == (32, 1, 80, 144, 1)
            assert torch.equal(out.flow, eager.flow)
            assert torch.equal(out.flow_history, eager.flow_history)
    tracer = profiling.Tracer(torch.device("cuda", 0))
    traced = FlowEngine(model, tracer=tracer)
    for p, out in zip(pairs, outs):
        got = traced.flow(*p, 32)
        assert torch.equal(got.flow, out.flow)
        assert torch.equal(got.flow_history, out.flow_history)
    doc = tracer.export()
    assert doc["stamps_mismatched"] == doc["stamps_dropped"] == 0
    forward = ["encode", "corr"] + 32 * ["lookup", "coarse_gru", "update"] + ["upsample"]
    call = doc["calls"][-1]
    stamps = [s for s in doc["stamps"] if s["call"] == call["id"]]
    assert [s["name"] for s in stamps] == ["copy_in", END] + forward + [END, "clone_out", END]
    marks = sum(s["replay"] for s in stamps)
    assert traced.graph_nodes[label] == engine.graph_nodes[label] + marks


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("name", ["instance_norm", "corr_lookup", "corr_lookup_1d", "lm_step"])
def test_untaken_dtypes_raise_on_card(name):
    """A float16 (float64 for the LM) card input without a gradient goes to
    the kernel's wrapper, which raises: the kernel does not give way to the
    plain chain on the card."""
    from test_torch_port_dispatch import _untaken_calls

    with torch.no_grad(), pytest.raises(TypeError):
        _untaken_calls("cuda")[name]()
