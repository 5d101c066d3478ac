"""The port's training data path on LINEMOD-format data against the JAX
package's, on the CPU (`_torch_port_linemod_common`: a 64^2 dataset written
by the port's writer, every other train frame `is_syn`, VOC trees of the
committed JPEG fixtures).

* VOC backgrounds: `sample_at(idx, pos)` of `is_syn` frames equals the JAX
  sample at several positions (image within 1e-5: the warp's and the
  resize's f32 rounding, cv2 on the JAX side; poses, crop intrinsics, depth
  and correspondences exact), with a full VOC tree, with the list file
  missing (no draw: the same sample as without `voc_root`), and with
  backgrounds that cannot be read (junk, a cut JPEG, a missing file: the
  draw is made, the image is left as it was), which fixes the draw order.
* The batch stream: the first 3 batches of `tools/train.dataset_batches`
  (sampler, `sample_at` at stream positions, collate; 2 threads and
  synchronous) equal the JAX stream's collated arrays, and a stream
  fast-forwarded past step 1 continues it.
* One training step on the stream's first batch: the loss terms (rtol
  1e-3) and the per-parameter gradients (cosine above 0.999, norm within
  1%, the bound of `test_torch_port_train_model.py`) against `jax.grad` of
  the JAX train loss, f32, the same weights through `load_jax_params`. The
  raw gradients, not the parameters after Adam (ROADMAP Queue 3, trap a);
  on the capsule this point is well conditioned (global norm asserted
  below 1e6).

Both packages build the KPConv pyramid with numpy here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import _torch_port_linemod_common as L
import _torch_port_train_common as T
import rnnpose_tpu.data.pyramid as jpyr
import rnnpose_tpu_torch.data.pyramid as tpyr

pytest.importorskip("cv2")

TERMS = ("loss", "circle_loss", "recall", "flow_loss", "reproj_loss", "loss_3d_proj")


@pytest.fixture(scope="module")
def numpy_pyramids():
    mp = pytest.MonkeyPatch()
    mp.setattr(jpyr, "_cpp", lambda: None)
    mp.setattr(tpyr, "_cpp", lambda: None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_lm")
    return root, L.write_train_fixture(root)


def _configs(cfg_path):
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu.utils import config_io as jio
    from rnnpose_tpu_torch.config import defaults as tdef
    from rnnpose_tpu_torch.utils import config_io as tio

    cj = jio.merge_cfg([cfg_path], defaults=jdef.default_config())
    ct = tio.merge_cfg([cfg_path], defaults=tdef.default_config())
    return cj, ct


def _datasets(cfg_path, voc_root="<config>"):
    """The train datasets of both packages from the fixture's config, with
    another `voc_root` if given."""
    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu_torch.config import defaults as tdef

    cj, ct = _configs(cfg_path)
    if voc_root != "<config>":
        for c in (cj, ct):
            c["train_input_reader"]["dataset"]["kwargs"]["voc_root"] = voc_root
    j = jdef.build_dataset(cj, jdef.build_model_config(cj).desc_kp, is_train=True)
    t = tdef.build_dataset(ct, tdef.build_model_config(ct).desc_kp, is_train=True)
    return j, t


def _check_sample(s_t, s_j):
    np.testing.assert_allclose(s_t["image"], s_j["image"], atol=1e-5)
    for key in ("intrinsics", "orig_intrinsics", "T_gt", "T_init", "depth"):
        np.testing.assert_array_equal(s_t[key], s_j[key], err_msg=key)
    for f in s_t["corr"]._fields:
        np.testing.assert_array_equal(getattr(s_t["corr"], f), getattr(s_j["corr"], f),
                                      err_msg=f)


SYN = (0, 2, 4)       # the is_syn train frames
POSITIONS = (0, 3, 11)


def test_voc_backgrounds_match_jax(fixture, numpy_pyramids):
    _, cfg_path = fixture
    j, t = _datasets(cfg_path)
    assert [t.frames[i].get("is_syn") for i in range(6)] == [True, False] * 3
    _, plain = _datasets(cfg_path, voc_root=None)
    pasted = 0
    for i in SYN:
        for pos in POSITIONS:
            s_t = t.sample_at(i, pos)
            _check_sample(s_t, j.sample_at(i, pos))
            # The draw comes first: every later draw of the sample shifts.
            pasted += not np.array_equal(s_t["T_init"], plain.sample_at(i, pos)["T_init"])
    assert pasted == len(SYN) * len(POSITIONS)
    # A real frame takes no background and draws nothing for one.
    _check_sample(t.sample_at(1, 5), plain.sample_at(1, 5))


def test_voc_list_missing_or_backgrounds_unreadable_match_jax(fixture, tmp_path,
                                                              numpy_pyramids):
    _, cfg_path = fixture
    _, plain = _datasets(cfg_path, voc_root=None)
    (tmp_path / "empty").mkdir()
    j, t = _datasets(cfg_path, voc_root=str(tmp_path / "empty"))
    for i, pos in ((0, 0), (2, 7)):
        s_t = t.sample_at(i, pos)
        _check_sample(s_t, j.sample_at(i, pos))
        _check_sample(s_t, plain.sample_at(i, pos))  # no list file: no draw
    bad = L.voc_tree(tmp_path / "bad", L.bad_voc_entries())
    j, t = _datasets(cfg_path, voc_root=bad)
    for i, pos in ((0, 0), (2, 7), (4, 12)):
        s_t = t.sample_at(i, pos)
        _check_sample(s_t, j.sample_at(i, pos))
        s_p = plain.sample_at(i, pos)
        assert not np.array_equal(s_t["T_init"], s_p["T_init"])  # drawn, then left alone


def _jax_stream(dataset, cfg, last_iter, n):
    """The JAX CLI's batch stream (`rnnpose_tpu/tools/train.py` `batches`,
    one process), synchronous: the first `n` collated batches."""
    from rnnpose_tpu.data.linemod import collate_samples
    from rnnpose_tpu.data.preprocess import TooFewCorrespondences
    from rnnpose_tpu.data.samplers import GivenIterationSampler

    bs = cfg["train_input_reader"]["batch_size"]
    sampler = GivenIterationSampler(len(dataset), total_iter=cfg["train_config"]["steps"],
                                    batch_size=bs, last_iter=last_iter)
    it = iter(enumerate(sampler))
    start = (last_iter + 1) * bs
    out = []
    while len(out) < n:
        samples = []
        while len(samples) < bs:
            k, idx = next(it)
            try:
                samples.append(dataset.sample_at(idx, start + k))
            except TooFewCorrespondences:
                continue
        out.append(collate_samples(samples))
    return out


def _check_batch(b_t, b_j):
    np.testing.assert_allclose(b_t.image.numpy(), b_j.image, atol=1e-5)
    for f in ("intrinsics", "T_init", "T_gt", "model_points", "point_valid"):
        np.testing.assert_array_equal(getattr(b_t, f).numpy(), getattr(b_j, f), err_msg=f)
    for f in b_t.corr._fields:
        np.testing.assert_array_equal(getattr(b_t.corr, f).numpy(), getattr(b_j.corr, f),
                                      err_msg=f)
    for f in ("points", "masks", "neighbors"):
        for a, b in zip(getattr(b_t.pyramid, f), getattr(b_j.pyramid, f)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


@pytest.fixture(scope="module")
def streams(fixture, numpy_pyramids):
    from rnnpose_tpu_torch.tools.train import dataset_batches

    _, cfg_path = fixture
    cj, ct = _configs(cfg_path)
    for c in (cj, ct):
        c["train_config"]["steps"] = 5
        c["train_input_reader"]["batch_size"] = 2
    j, t = _datasets(cfg_path)
    jax_batches = _jax_stream(j, cj, -1, 3)
    port = {}
    for threads in (2, 0):
        loader = dataset_batches(t, ct, -1, threads, "cpu")
        port[threads] = [b for b, _ in zip(loader, range(3))]
        getattr(loader, "close", lambda: None)()
    resumed = dataset_batches(t, ct, 1, 2, "cpu")
    port["resumed"] = [b for b, _ in zip(resumed, range(1))]
    resumed.close()
    return jax_batches, port, cj


def test_batch_stream_matches_jax(streams):
    jax_batches, port, _ = streams
    for threads in (2, 0):
        assert len(port[threads]) == 3
        for b_t, b_j in zip(port[threads], jax_batches):
            assert b_t.image.shape == (2, 64, 64, 3)
            _check_batch(b_t, b_j)
    # Fast-forwarded past step 1 (a resume at step 2): the third batch.
    _check_batch(port["resumed"][0], jax_batches[2])


def test_first_step_gradients_match_jax(streams):
    import jax

    from rnnpose_tpu.config import defaults as jdef
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose
    from rnnpose_tpu_torch.models.convert import flax_to_state_dict

    jax_batches, port, cj = streams
    jcfg = jdef.build_model_config(cj)
    jcfg = dataclasses.replace(jcfg, refiner=dataclasses.replace(jcfg.refiner,
                                                                 mixed_precision=False))
    jmodel = JRNNPose(jcfg)
    inputs = jax.tree.map(jax.numpy.asarray, jax_batches[0])
    params = jax.jit(lambda k: jmodel.init(k, inputs, train=False))(jax.random.PRNGKey(0))
    params = T.offset_biases(jax.device_get(params))

    def loss_fn(p):
        out = jmodel.apply(p, inputs, train=True)
        return out["loss"], {k: out[k] for k in TERMS}

    (_, terms_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads_j = flax_to_state_dict(jax.device_get(grads_j))
    model = T.port_model(jmodel, params)
    out = model(port[2][0], train=True)
    out["loss"].backward()
    for k in TERMS:
        np.testing.assert_allclose(float(out[k].detach()), float(terms_j[k]), rtol=1e-3,
                                   err_msg=k)
    norms = {n: (float(np.linalg.norm(grads_j[n])), float(p.grad.norm()))
             for n, p in model.named_parameters() if p.grad is not None}
    top = max(max(v) for v in norms.values())
    checked = []
    for n, (nj, nt) in norms.items():
        if max(nj, nt) < 1e-6 * top:
            continue
        gj = grads_j[n].ravel().astype(np.float64)
        gt = dict(model.named_parameters())[n].grad.numpy().ravel().astype(np.float64)
        cos = float(gj @ gt / (np.linalg.norm(gj) * np.linalg.norm(gt) + 1e-300))
        assert cos > 0.999, f"gradient direction diverges at {n}: {cos}"
        assert 0.99 < nt / nj < 1.01, f"gradient magnitude diverges at {n}: {nt / nj}"
        checked.append(n)
    for prefix in ("hybrid_desc_net.", "ctx_fea_net.", "motion_net.cf_net."):
        assert any(n.startswith(prefix) for n in checked), prefix
    assert torch.isfinite(out["loss"])
