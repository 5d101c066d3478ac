"""The port's pretrained loader against the JAX package's.

`models/convert.load_pretrained` reads a reference torch file, as the JAX
package's `load_pretrained` does: a full-model checkpoint through the
include/exclude filters and the rename map, or a bare sub-network file
(SuperPoint, the RAFT encoder, the update block). Both packages load the
same file into the same starting weights; the JAX result, mapped with
`load_jax_params`, must equal the port's model tensor for tensor
(bound: equal), and the unmatched keys must be the JAX package's.
`export_reference_state_dict` must equal the JAX export and round-trip
exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_port_common as C
from rnnpose_tpu.models import convert as J
from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, kpconv_config
from rnnpose_tpu_torch.models import convert as T
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig

NUM_LAYERS = 3  # the tiny scene's towers


@pytest.fixture(scope="module")
def params():
    """Two parameter sets of the whole tiny JAX model (towers included):
    the source of the files, and the weights they are loaded into."""
    from rnnpose_tpu.models.refiner import RefinerConfig as JRefiner
    from rnnpose_tpu.models.rnnpose import RNNPose as JRNNPose
    from rnnpose_tpu.models.rnnpose import RNNPoseConfig as JConfig

    inputs, kp = C.jax_scene(1)
    model = JRNNPose(JConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=JRefiner(render_iters=1, gru_iters=1, **C.TINY_REFINER)))
    init = jax.jit(lambda k: model.init(k, inputs, train=False))
    return tuple(jax.device_get(init(jax.random.PRNGKey(s))) for s in (0, 1))


def _port(flax_params):
    kp = kpconv_config(SyntheticConfig(kp_layers=NUM_LAYERS, kp_dl=0.015, **C.TINY_SCENE))
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(**C.refiner_kwargs(render_iters=1, gru_iters=1))))
    return T.load_jax_params(model, flax_params)


def _assert_models_equal(port, flax_params):
    want = _port(flax_params).state_dict()
    got = port.state_dict()
    assert set(got) == set(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ[:5]


def _load_both(params, path, capsys, **kw):
    """(port model after its load, unmatched keys, its printed line), with
    the JAX package's load of the same file into the same weights checked
    equal, printed line included."""
    src, dst = params
    jax_out = J.load_pretrained(dst, path, num_layers=NUM_LAYERS, **kw)
    jax_printed = capsys.readouterr().out
    port = _port(dst)
    unmatched = T.load_pretrained(port, path, **kw)
    printed = capsys.readouterr().out
    assert printed == jax_printed
    _assert_models_equal(port, jax_out)
    return port, unmatched, printed


def _jax_bare_unmatched(params, sd):
    """The keys the JAX package's bare-file routes all skip (its
    `load_pretrained` prints only their count)."""
    p = params["params"]
    unmatched = {k for k in sd if not J._is_ignored(k)}
    for name_map, root in ((J.SUPERPOINT_MAP, ("hybrid", "desc2d")),
                           (J.RAFT_ENCODER_MAP, ("motion", "image_fea_enc")),
                           (J.RAFT_UPDATE_MAP, ("motion", "inner", "cf_step"))):
        unmatched &= set(J.torch_to_flax(sd, name_map, J._get_path(p, root))[1])
    return unmatched


@pytest.mark.parametrize("which", ["superpoint", "encoder", "update"])
def test_bare_sub_network_file_loads_as_jax(params, which, tmp_path, capsys):
    """`superpoint_v1.pth`, `img_fea_enc.pth` and `gru_update.pth` as the
    reference ships them: the sub-module's own keys, plus an ignored buffer,
    an unknown key and (encoder) a SuperPoint key of the wrong shape."""
    src = _port(params[0])
    module = {"superpoint": src.hybrid_desc_net.corr_fea_extractor_2d,
              "encoder": src.motion_net.image_fea_enc,
              "update": src.motion_net.cf_net}[which]
    sd = dict(module.state_dict())
    sd["fnet.norm1.running_mean"] = torch.zeros(64)
    sd["unknown_head.weight"] = torch.ones(3, 3)
    if which == "encoder":
        sd["conv1a.weight"] = torch.ones(1, 1, 1, 1)
    path = str(tmp_path / f"{which}.pth")
    torch.save(sd, path)
    port, unmatched, printed = _load_both(params, path, capsys)
    expect = _jax_bare_unmatched(params[1], {k: v.numpy() for k, v in sd.items()})
    assert sorted(unmatched) == sorted(expect)
    assert set(unmatched) >= {"unknown_head.weight"}
    assert printed == f"load_pretrained: {len(unmatched)} torch keys unmatched\n"
    # The file's sub-module now holds the source's weights.
    for k, v in module.state_dict().items():
        assert torch.equal(port.get_submodule(
            {"superpoint": "hybrid_desc_net.corr_fea_extractor_2d",
             "encoder": "motion_net.image_fea_enc",
             "update": "motion_net.cf_net"}[which]).state_dict()[k], v), k


def test_full_checkpoint_with_filters_and_renames_loads_as_jax(params, tmp_path, capsys):
    """A full-model file under a `state_dict` key, keys renamed away and
    back, a regex include and exclude, the ignored keys, an unknown key and
    a wrong shape."""
    src = _port(params[0])
    sd = {k.replace("motion_net.", "refiner_net."): v
          for k, v in T.export_reference_state_dict(src).items()}
    sd["global_step"] = torch.tensor(7)
    sd["hybrid_desc_net.corr_fea_extractor_3d.epsilon"] = torch.tensor(1e-6)
    sd["refiner_net.unknown.weight"] = torch.ones(2)
    sd["refiner_net.sigma.0"] = torch.ones(3)
    sd["not_a_route.weight"] = torch.ones(1)
    path = str(tmp_path / "full.tckpt")
    torch.save({"state_dict": sd}, path)
    port, unmatched, printed = _load_both(
        params, path, capsys, include=r"^(hybrid|ctx|refiner|global|not)",
        exclude=r"corr_fea_extractor_3d\.decoder|fnet\.layer3",
        rename_map={"refiner_net.": "motion_net."})
    assert unmatched == ["motion_net.sigma.0", "motion_net.unknown.weight",
                         "not_a_route.weight"]
    assert printed.startswith("load_full_checkpoint: 3 torch keys unmatched")
    # Excluded and unmatched tensors keep the starting weights; the rest
    # are the source's.
    start, got, want = _port(params[1]).state_dict(), port.state_dict(), src.state_dict()
    for k in got:
        kept = ("corr_fea_extractor_3d.decoder" in k or "fnet.layer3" in k
                or k == "motion_net.sigma.0")
        assert torch.equal(got[k], start[k] if kept else want[k]), k


def test_export_reference_state_dict_round_trips(params, tmp_path, capsys):
    src = _port(params[0])
    sd = T.export_reference_state_dict(src)
    ref = J.export_reference_state_dict(params[0], NUM_LAYERS)
    assert list(sd) == list(ref)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    assert set(sd) == set(src.state_dict())
    path = str(tmp_path / "export.tckpt")
    torch.save(sd, path)
    dst = _port(params[1])
    assert T.load_pretrained(dst, path) == []
    assert capsys.readouterr().out == ""
    _assert_models_equal(dst, params[0])


def test_train_cli_loads_a_bare_superpoint_file(params, tmp_path, monkeypatch):
    """`tools/train.py --pretrained_path superpoint_v1.pth` loads the file
    non-strictly into the model it trains."""
    from rnnpose_tpu_torch.tools import train as train_cli

    path = str(tmp_path / "superpoint_v1.pth")
    sp = _port(params[0]).hybrid_desc_net.corr_fea_extractor_2d.state_dict()
    torch.save(sp, path)
    seen = {}
    real = T.load_pretrained

    def spy(model, p, **kw):
        seen["unmatched"] = real(model, p, **kw)
        seen["sp"] = {k: v.clone() for k, v in
                      model.hybrid_desc_net.corr_fea_extractor_2d.state_dict().items()}
        return seen["unmatched"]

    monkeypatch.setattr(T, "load_pretrained", spy)
    train_cli.main(["--synthetic", "--syn_image_size", "64", "--syn_zoom", "32",
                    "--device", "cpu", "--model_dir", str(tmp_path / "run"), "--steps", "1",
                    "--pretrained_path", path])
    assert seen["unmatched"] == []
    assert all(torch.equal(seen["sp"][k], v) for k, v in sp.items())
