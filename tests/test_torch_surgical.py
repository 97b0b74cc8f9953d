"""The port's surgical fine-tuning against the JAX package: the layer set,
the architectural groups and the head rule on the same tensors, RGN and
eb-criterion weights on the same batches, the surgical optimizer against
its optax chain, and the legacy grid fine-tuning CLI.

The model is the continual tests' small geometry in float32 (img 32, embed
16, depths 1/1/1/1), weights from a JAX init carried over with
``params_from_jax``. Tolerances: RGN weights rtol 1e-4 per tensor (ratios
of float32 gradient norms of two frameworks); eb-criterion raw weights rtol
1e-3 (a mean of g² over a variance of the same gradient), binarized weights
equal wherever the raw weight is more than 1e-3 from the 0.95 threshold;
three optimizer updates within 1e-6 absolute of optax's (float32
arithmetic of the same formula).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cswin_unet_tpu import losses as jax_losses
from cswin_unet_tpu.data import make_synthetic_dataset
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.train import surgical as jax_surgical
from cswin_unet_tpu.train import tpgm as jax_tpgm
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch import finetune
from cswin_unet_tpu_torch.losses import focal_loss
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.train import finetune as port_finetune
from cswin_unet_tpu_torch.train import surgical, tpgm
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

SMALL = dict(img_size=32, num_classes=7, embed_dim=16, depth=(1, 1, 1, 1),
             split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))
TINY_YAML = ("MODEL:\n  TYPE: cswin\n  NAME: cswin_test_tiny\n  DROP_PATH_RATE: 0.1\n"
             "  PRETRAIN_CKPT: \"\"\n  CSWIN:\n    EMBED_DIM: 16\n"
             "    DEPTH: [1, 1, 1, 1]\n    NUM_HEADS: [2, 2, 4, 8]\n"
             "    SPLIT_SIZE: [1, 2, 2, 1]\n")
CW = np.linspace(0.2, 1.4, 7).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jm = JaxCSwinUnet(backbone=JaxCSWinUNet(**SMALL))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}
    backbone = CSWinUNet(**SMALL, dtype=torch.float32)
    backbone.load_state_dict(params_from_jax(flat))
    return (jm, params), CSwinUnet(backbone).train()


@pytest.fixture(scope="module")
def jax_grad_fn(models):
    """One compiled JAX gradient for every JAX weight computation here."""
    (jm, _), _ = models
    return jax_surgical.make_grad_fn(jm, jax_focal)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(5)
    return [{"image": rng.standard_normal((2, 32, 32, 1)).astype(np.float32),
             "label": rng.integers(0, 7, (2, 32, 32)).astype(np.int32)} for _ in range(2)]


def jax_focal(logits, labels):
    return jax_losses.focal_loss(logits, labels, alpha=1.0, gamma=4.0,
                                 class_weights=jnp.asarray(CW))


def port_focal(logits, labels):
    return focal_loss(logits, labels, alpha=1.0, gamma=4.0,
                      class_weights=torch.from_numpy(CW))


def test_surgery_names_map_onto_jax(models):
    """Every port key's JAX name is a JAX parameter, one to one; the layer
    filter, the groups and the head verdicts agree tensor by tensor (the
    stem's LayerNorm, ``stage1_conv_embed.2`` here, is excluded as JAX's
    ``stage1_conv_embed_norm``)."""
    (_, params), port = models
    jflat = jax_ckpt.flatten(jax.device_get(params))
    pparams = surgical.backbone_params(port)
    to_jax = {k: surgical.jax_name(k, v.ndim) for k, v in pparams.items()}
    assert sorted(to_jax.values()) == sorted(jflat) and len(set(to_jax.values())) == len(jflat)
    assert ({to_jax[k] for k in surgical.surgical_layer_names(pparams)}
            == set(jax_surgical.surgical_layer_names(params)))
    assert "stage1_conv_embed.2.weight" not in surgical.surgical_layer_names(pparams)
    for k, v in pparams.items():
        assert surgical.parameter_group_of(k) == jax_surgical.parameter_group_of(to_jax[k]), k
        assert tpgm._is_head(k, v.ndim) == jax_tpgm._is_head(to_jax[k]), k
    groups = {surgical.parameter_group_of(k) for k in pparams}
    assert "other" not in groups and len(groups) == 22
    assert [k for k, v in pparams.items() if tpgm._is_head(k, v.ndim)] == ["output.weight"]


def test_rgn_weights_match_jax(models, batches, jax_grad_fn):
    """Per-tensor RGN over two batches and per-group RGN on one, on the
    same weights and batches."""
    (jm, params), port = models
    got = surgical.get_lr_weights(port, batches, port_focal, method="RGN")
    want = jax_surgical.get_lr_weights(jm, params, batches, jax_focal, method="RGN",
                                       grad_fn=jax_grad_fn)
    pparams = surgical.backbone_params(port)
    assert len(got) == len(want)
    for k, v in got.items():
        assert v == pytest.approx(want[surgical.jax_name(k, pparams[k].ndim)], rel=1e-4,
                                  abs=1e-12), k
    assert port.training  # the grad pass restored the mode
    gw = surgical.get_group_lr_weights(port, batches[0], port_focal)
    jgw = jax_surgical.get_group_lr_weights(jm, params, batches[0], jax_focal,
                                            grad_fn=jax_grad_fn)
    assert gw.keys() == jgw.keys()
    for k in gw:
        assert gw[k] == pytest.approx(jgw[k], rel=1e-4), k
    pw = surgical.group_weights_to_param_weights(pparams, gw)
    jpw = jax_surgical.group_weights_to_param_weights(params, jgw)
    assert all(pw[k] == pytest.approx(jpw[surgical.jax_name(k, v.ndim)], rel=1e-4)
               for k, v in pparams.items())


def test_eb_criterion_matches_jax(models, batches, jax_grad_fn):
    """eb-criterion's variance runs over axis 0 of the JAX layout."""
    (jm, params), port = models
    got = surgical.get_lr_weights(port, batches, port_focal, method="eb-criterion")
    want = jax_surgical.get_lr_weights(jm, params, batches, jax_focal,
                                       method="eb-criterion", grad_fn=jax_grad_fn)
    pparams = surgical.backbone_params(port)
    names = {k: surgical.jax_name(k, pparams[k].ndim) for k in got}
    assert sorted(names.values()) == sorted(want)
    for k, v in got.items():
        assert v == pytest.approx(want[names[k]], rel=1e-3), k
    gb = surgical.normalize_weights(got, "eb-criterion")
    wb = jax_surgical.normalize_weights(want, "eb-criterion")
    clear = [k for k in got if abs(want[names[k]] - 0.95) > 1e-3]
    assert clear and all(gb[k] == wb[names[k]] for k in clear)
    assert set(gb.values()) == {0.0, 1.0}


def test_surgical_optimizer_matches_optax():
    """Three updates (epochs 0, 0, 1) on the same θ, gradients and weights,
    one tensor frozen (weight 0, its moments advancing), gradients above
    and below the clip norm."""
    rng = np.random.default_rng(3)
    shapes = {"a.weight": (6, 5), "b.weight": (4, 3, 3, 3), "c.bias": (7,), "d.weight": (5,)}
    theta = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    weights = {"a.weight": 1.0, "b.weight": 0.37, "c.bias": 0.0}  # d absent: frozen
    steps = [(0, 3.0), (0, 0.05), (1, 2.0)]  # (epoch, gradient scale)

    jopt = jax_surgical.SurgicalOptimizer(base_lr=0.02, max_epochs=4)
    jp = {k: jnp.asarray(v) for k, v in theta.items()}
    state = jopt.init(jp)
    jw = {k: jnp.asarray(weights.get(k, 0.0), jnp.float32) for k in theta}
    tp = {k: torch.from_numpy(v.copy()) for k, v in theta.items()}
    opt = surgical.SurgicalOptimizer(tp, 0.02, 4)
    for epoch, scale in steps:
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp, jw,
                                 jnp.asarray(float(epoch)))
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()}, weights, epoch)
        for k in theta:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    for k in ("c.bias", "d.weight"):
        np.testing.assert_array_equal(tp[k].numpy(), theta[k])
    assert float(opt._adam.mu[2].abs().max()) > 0  # the frozen tensor's moments moved
    assert surgical.cosine_epoch_lr(0.1, 10)(5) == pytest.approx(0.05)


def test_finetune_cli_saves_grid_cell(tmp_path, monkeypatch):
    """``python -m cswin_unet_tpu_torch.finetune`` on the CPU: one grid cell
    (the grid cut to its first cell), one epoch of per-group RGN steps,
    ``model_lr0.001_wd0.0001_epoch0.npz`` readable by the JAX loader."""
    info = make_synthetic_dataset(str(tmp_path / "data"), num_train_slices=10,
                                  num_volumes=1, size=40, depth=2, num_classes=9, seed=4)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    monkeypatch.setattr(port_finetune, "LR_WD_GRID", port_finetune.LR_WD_GRID[:1])
    out = tmp_path / "ft"
    msg = finetune.main(["--cfg", str(cfg), "--root_path", info["train_dir"],
                         "--list_dir", info["list_dir"], "--output_dir", str(out),
                         "--img_size", "32", "--batch_size", "2", "--max_epochs", "1",
                         "--pretrained_ckpt", str(tmp_path / "none.npz"),
                         "--device", "cpu"])
    assert msg == "Surgical Training Finished!"
    path = out / "model_lr0.001_wd0.0001_epoch0.npz"
    assert os.path.exists(path)
    tree, _ = jax_ckpt.load_checkpoint(str(path))
    flat = jax_ckpt.flatten(jax_ckpt._backbone_of(tree))
    assert flat["output/kernel"].shape == (1, 1, 16, 9)
    assert all(np.isfinite(v).all() for v in flat.values())
    log = (out / "log.txt").read_text()
    assert "RGN chosen parameters: output = " in log and log.count("Loss: ") == 1
    logging.getLogger().handlers.clear()
