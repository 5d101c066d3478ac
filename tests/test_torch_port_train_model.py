"""The whole training forward and backward against the JAX package: the
`__graft_entry__._tiny_setup` scene with its correspondence set (B=2), f32,
both towers, the same weights through `load_jax_params`.

* Every reported loss term within rtol 1e-3; the saliency scores within
  1e-4.
* Per parameter, the gradient's cosine with `jax.grad`'s above 0.999 and its
  norm within 1% (the bound of `test_refiner_gradient_parity`,
  PARITY.md:225-230), the JAX gradient tree mapped onto torch names through
  `flax_to_state_dict` (transposes included). Excluded, as there: leaves
  whose gradient is float noise on both sides (norm below 1e-6 of the
  largest), which must be biases that an InstanceNorm cancels or the
  saliency head, which feeds no loss.
* The gradient reaches the 2D net, both towers and the refiner.
* The port's flax paths are the JAX tree's (kernel points aside).

This point is well conditioned (global gradient norm asserted below 1e6,
ROADMAP Queue 3 trap a) at the scene's default two render iterations.
"""
import jax
import numpy as np
import pytest

import _torch_port_common  # noqa: F401  (pins torch to one thread)
import _torch_port_train_common as T
from rnnpose_tpu_torch.models.convert import flax_paths, flax_to_state_dict

TERMS = ("loss", "circle_loss", "recall", "flow_loss", "reproj_loss", "loss_3d_proj")


@pytest.fixture(scope="module")
def both():
    jmodel, params, inputs = T.jax_train_setup(batch_size=2, render_iters=2)

    def loss_fn(p):
        out = jmodel.apply(p, inputs, train=True)
        return out["loss"], {k: out[k] for k in TERMS + ("scores_2d",)}

    (_, terms_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = T.port_model(jmodel, params)
    out_t = port(T.port_train_inputs(inputs), train=True)
    out_t["loss"].backward()
    grads_t = {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
               for n, p in port.named_parameters()}
    terms_t = {k: float(out_t[k].detach()) for k in TERMS}
    terms_t["scores_2d"] = out_t["scores_2d"].detach().numpy()
    return params, port, jax.device_get(terms_j), terms_t, flax_to_state_dict(
        jax.device_get(grads_j)), grads_t


def test_loss_terms_match_jax(both):
    _, _, terms_j, terms_t, *_ = both
    for k in TERMS:
        np.testing.assert_allclose(terms_t[k], float(terms_j[k]), rtol=1e-3, err_msg=k)
    # The saliency head runs on every training step and feeds no loss.
    assert terms_t["scores_2d"].shape == (2, 96, 96, 1)
    np.testing.assert_allclose(terms_t["scores_2d"], np.asarray(terms_j["scores_2d"]),
                               atol=1e-4)
    assert terms_t["recall"] >= 0.0 and terms_t["circle_loss"] > 0.0


def test_gradients_match_jax(both):
    *_, grads_j, grads_t = both
    # KPConv kernel points are parameters in flax (never trained), buffers
    # in the port.
    assert {n for n in grads_j if n not in grads_t} == {
        n for n in grads_j if n.endswith("KPConv.kernel_points")}
    assert set(grads_t) <= set(grads_j)
    norms = {n: (np.linalg.norm(grads_j[n]), np.linalg.norm(grads_t[n])) for n in grads_t}
    top = max(max(v) for v in norms.values())
    global_norm = np.sqrt(sum(nt ** 2 for _, nt in norms.values()))
    assert global_norm < 1e6, global_norm  # a well-conditioned point (trap a)
    checked, skipped, worst = [], [], (2.0, "")
    for n, (nj, nt) in norms.items():
        if max(nj, nt) < 1e-6 * top:
            skipped.append(n)
            continue
        gj, gt = grads_j[n].ravel(), grads_t[n].ravel()
        cos = float(gj @ gt / (nj * nt + 1e-30))
        worst = min(worst, (cos, n))
        assert cos > 0.999, f"gradient direction diverges at {n}: {cos}"
        assert 0.99 < nt / nj < 1.01, f"gradient magnitude diverges at {n}: {nt / nj}"
        checked.append(n)
    assert all(n.endswith(".bias") or ".convP" in n for n in skipped), skipped
    for prefix in ("hybrid_desc_net.corr_fea_extractor_2d.",
                   "hybrid_desc_net.corr_fea_extractor_3d.",
                   "ctx_fea_net.context_fea_extractor_3d.", "motion_net.cf_net.",
                   "motion_net.image_fea_enc.", "motion_net.sigma"):
        assert any(n.startswith(prefix) for n in checked), prefix
    print(f"worst cosine {worst[0]:.6f} at {worst[1]} over {len(checked)} leaves; "
          f"{len(skipped)} noise leaves; global norm {global_norm:.4g}")


def test_flax_paths_are_the_jax_trees(both):
    params, port, *_ = both
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    ours = set(flax_paths(port).values())
    assert ours == {p for p in leaves if not p.endswith("kernel_points")}
