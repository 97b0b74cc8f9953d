"""The port's TPGM against the JAX package: the constraint init and the
projection (v1 and v3, l2 and MARS norms) on the small model's tensors, the
gradient with respect to the constraints, and the constraint optimization
loop with its final projection, on the model's composed blocks and through
``CSWinBlockFn``.

The model is the continual tests' small geometry in float32, weights from a
JAX init carried over with ``params_from_jax``; the drifted weights are the
anchor plus seeded noise. Tolerances: constraints rtol 1e-6 (float32
arithmetic of the same formula); the ratios rtol 4e-6 and each projected
tensor within 4e-6 of its largest element (a ratio divides by a float32
norm that the two frameworks sum in another order); constraint gradients of a
fixed quadratic objective rtol 1e-5; after 4 optimization steps on the
model's loss the constraints within rtol 1e-3 and each projected tensor
within relative L2 1e-4 of JAX's (two frameworks' float32 gradients
through the model, normalized by Adam).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.train import tpgm as jax_tpgm
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.models import cswin_unet as port_unet
from cswin_unet_tpu_torch.ops.cuda.cswin_block import CSWinBlockFn
from cswin_unet_tpu_torch.train import tpgm
from cswin_unet_tpu_torch.train.surgical import jax_name
from cswin_unet_tpu_torch.utils.checkpoint import _jax_layout, params_from_jax

torch.set_num_threads(2)

SMALL = dict(img_size=32, num_classes=7, embed_dim=16, depth=(1, 1, 1, 1),
             split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))
CASES = [("v1", "l2"), ("v1", "mars"), ("v3", "l2"), ("v3", "mars")]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.fixture(scope="module")
def setup():
    """(JAX model, anchor tree), the port model, and the drifted weights of
    each variant (JAX flat names -> numpy): for v1 small noise (its init is
    half the drift), for v3 noise scaled to twice the permissive init in the
    variant's norm, so the ratios sit near 0.5 and the gradients flow."""
    jm = JaxCSwinUnet(backbone=JaxCSWinUNet(**SMALL))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    params = jax.device_get(params)
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(params).items()}
    backbone = CSWinUNet(**SMALL, dtype=torch.float32)
    backbone.load_state_dict(params_from_jax(flat))
    rng = np.random.default_rng(8)
    init3 = jax_tpgm.init_constraints(params)
    drifted = {}
    for norm in ("l2", "mars"):
        d1, d3 = {}, {}
        for k, v in flat.items():
            noise = rng.standard_normal(v.shape).astype(np.float32)
            d1[k] = v + 0.05 * noise
            size = np.linalg.norm(noise) if norm == "l2" else np.abs(noise).sum()
            d3[k] = v + noise / size * 2.0 * float(init3[k])
        drifted[("v1", norm)], drifted[("v3", norm)] = d1, d3
    return (jm, params), CSwinUnet(backbone).eval(), drifted


def _port(flat_np):
    return params_from_jax(flat_np)


def _by_port_key(port_params, jax_dict):
    return {k: jax_dict[jax_name(k, v.ndim)] for k, v in port_params.items()}


@pytest.mark.parametrize("variant,norm", CASES)
def test_init_and_project_match_jax(setup, variant, norm):
    (_, params), _, drifted = setup
    anchor = _port(jax_ckpt.flatten(params))
    theta = _port(drifted[(variant, norm)])
    jtree = jax_ckpt.unflatten(drifted[(variant, norm)])

    # as the trainer: v3 from the weights at construction (the anchor), v1
    # from the drift
    jc = jax_tpgm.init_constraints(jtree if variant == "v1" else params, variant=variant,
                                   anchor=params)
    c = tpgm.init_constraints(theta if variant == "v1" else anchor, variant=variant,
                              anchor=anchor)
    jc_p = _by_port_key(theta, jc)
    assert c.keys() == jc_p.keys()
    for k in c:
        np.testing.assert_allclose(float(c[k]), float(jc_p[k]), rtol=1e-6, err_msg=k)

    jproj, jratios = jax_tpgm.project(jtree, params, jc, norm_mode=norm, variant=variant)
    proj, ratios = tpgm.project(theta, anchor, c, norm_mode=norm, variant=variant)
    want = _port(jax_ckpt.flatten(jax.device_get(jproj)))
    jr = _by_port_key(theta, jratios)
    for k in theta:
        # a ratio divides by a float32 norm of up to 18,432 elements that
        # the two frameworks sum in another order (1.2e-6 apart measured);
        # a projected element carries that error on the tensor's scale
        np.testing.assert_allclose(float(ratios[k]), float(jr[k]), rtol=4e-6, err_msg=k)
        w = want[k].numpy()
        np.testing.assert_allclose(proj[k].numpy(), w, rtol=0,
                                   atol=4e-6 * float(np.abs(w).max()), err_msg=k)
    mean = float(np.mean([float(r) for r in ratios.values()]))
    assert 0.05 < mean < 0.95  # the projection is active, not saturated
    assert tpgm.ratio_stats(ratios) == pytest.approx(jax_tpgm.ratio_stats(jratios), rel=4e-6)


@pytest.mark.parametrize("variant,norm", CASES)
def test_constraint_gradient_matches_jax_grad(setup, variant, norm):
    """d/dc of the quadratic Σ_k Σ R_k ⊙ (θ_proj,k − θ_anchor,k)² with fixed
    R_k >= 0 (terms of one sign: the sums do not cancel), θ and the anchor
    detached (no gradient reaches θ)."""
    (_, params), _, drifted = setup
    anchor = _port(jax_ckpt.flatten(params))
    theta = _port(drifted[(variant, norm)])
    # every fifth tensor and the head: each kind of layout, a short compile
    keep = [k for i, k in enumerate(theta) if i % 5 == 0 or k == "output.weight"]
    theta = {k: theta[k] for k in keep}
    anchor = {k: anchor[k] for k in keep}
    jtree = jax_ckpt.unflatten({jax_name(k, v.ndim): drifted[(variant, norm)][
        jax_name(k, v.ndim)] for k, v in theta.items()})
    jparams = jax_ckpt.unflatten({jax_name(k, v.ndim): jax_ckpt.flatten(params)[
        jax_name(k, v.ndim)] for k, v in theta.items()})
    rng = np.random.default_rng(11)
    R = {k: rng.random(v.shape).astype(np.float32) for k, v in theta.items()}
    jc = jax_tpgm.init_constraints(jtree if variant == "v1" else jparams, variant=variant,
                                   anchor=jparams)
    jR = {jax_name(k, v.ndim): jnp.asarray(_jax_layout(R[k])) for k, v in theta.items()}
    ja = jax_ckpt.flatten(jparams)

    def jobjective(c):
        proj, _ = jax_tpgm.project(jtree, jparams, c, norm_mode=norm, variant=variant)
        fp = jax_ckpt.flatten(proj)
        return sum(jnp.sum(jR[k] * (fp[k] - ja[k]) ** 2) for k in jR)

    jgrad = _by_port_key(theta, jax.jit(jax.grad(jobjective))(jc))
    c = {k: v.requires_grad_() for k, v in
         tpgm.init_constraints(theta if variant == "v1" else anchor, variant=variant,
                               anchor=anchor).items()}
    leaves = {k: v.clone().requires_grad_() for k, v in theta.items()}
    proj, _ = tpgm.project(leaves, anchor, c, norm_mode=norm, variant=variant)
    obj = sum((torch.from_numpy(R[k]) * (proj[k] - anchor[k]) ** 2).sum() for k in proj)
    *grads, g_theta = torch.autograd.grad(obj, [*c.values(), *leaves.values()],
                                          allow_unused=True)[:len(c) + 1]
    assert g_theta is None  # θ is detached
    nonzero = 0
    for k, g in zip(c, grads):
        np.testing.assert_allclose(float(g), float(jgrad[k]), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
        nonzero += float(g) != 0.0
    assert nonzero > len(c) // 2 and len(c) == len(keep)


@pytest.fixture(scope="module")
def jax_optimized(setup):
    """JAX's constraints after 4 steps of the trainer's default (v3, l2)
    from the anchor, on the v3 drift, and its final projection."""
    (jm, params), _, drifted = setup
    tr = jax_tpgm.TPGMTrainer(jm, params, proj_lr=0.05, max_iters=4, active_classes=7)
    tr.optimize(jax_ckpt.unflatten(drifted[("v3", "l2")]), iter(_batches()),
                log=lambda *a: None)
    proj = jax_ckpt.flatten(jax.device_get(tr.apply(jax_ckpt.unflatten(
        drifted[("v3", "l2")]))))
    return ({k: float(v) for k, v in jax.device_get(tr.constraints).items()},
            {k: np.asarray(v) for k, v in proj.items()})


def _batches():
    rng = np.random.default_rng(12)
    return [{"image": rng.standard_normal((2, 32, 32, 1)).astype(np.float32),
             "label": rng.integers(0, 7, (2, 32, 32)).astype(np.int32)} for _ in range(4)]


@pytest.mark.parametrize("route", ["composed", "CSWinBlockFn"])
def test_tpgm_trainer_matches_jax(setup, jax_optimized, monkeypatch, route):
    """4 constraint steps (Adam after a clip at 1.0) on the model's loss,
    then ``apply``. Every block trains through the composition (its
    ``impl`` set to ``"plain"``), or through the kernel backward's Function
    (``CSWinBlockFn``, on the CPU its plain versions, last-stage blocks
    included), so the constraints' gradients pass through its weight
    gradients."""
    (_, params), model, drifted = setup
    if route == "composed":
        for b in model.modules():
            if isinstance(b, port_unet.CSWinBlock):
                monkeypatch.setattr(b, "impl", "plain")
    calls = []
    real_apply = CSWinBlockFn.apply
    monkeypatch.setattr(CSWinBlockFn, "apply",
                        lambda *a: calls.append(1) or real_apply(*a))
    anchor = _port(jax_ckpt.flatten(params))
    theta = _port(drifted[("v3", "l2")])
    tr = tpgm.TPGMTrainer(model, anchor, proj_lr=0.05, max_iters=4, active_classes=7)
    c0 = tr._constraint_values()
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _batches()]
    lines = []
    tr.optimize(theta, iter(batches), log=lines.append)
    assert lines[-1].startswith("TPGM optimization complete. Average constraint change: ")
    assert len(calls) == (4 * 8 if route == "CSWinBlockFn" else 0)  # 8 blocks a step
    assert not model.training

    jc, jproj = jax_optimized
    got = tr._constraint_values()
    moved = 0
    for k, v in theta.items():
        want = jc[jax_name(k, v.ndim)]
        np.testing.assert_allclose(got[k], want, rtol=1e-3, err_msg=k)
        moved += abs(got[k] - c0[k]) > 1e-3 * abs(c0[k])
    assert moved > len(got) // 2
    proj = tr.apply(theta)
    want = _port(jproj)
    for k in theta:
        assert _rel_l2(proj[k].numpy(), want[k].numpy()) <= 1e-4, k
