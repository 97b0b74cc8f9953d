"""The port's continual-learning slice against the JAX package: checkpoint
surgery, the stage bookkeeping and label map, the continual loss, the
positive-sampling loader, one continual train step, the master loop end to
end, and the ``universal_train`` / ``universal_test`` CLIs.

The model is ``tests/test_continual_e2e.py``'s small geometry (img 32,
embed 16, depths 1/1/1/1) in float32, weights from a JAX init carried over
with ``params_from_jax``. Tolerances: the expanded head's new rows and the
loader's batches equal bit for bit (the same numpy draws); the loss and
its logit gradient within 1e-5 (relative for the loss values, whose KD
term sums pixels to ~40; float32 arithmetic of the same formula); the
student's parameters after one step within relative L2 1e-4 all together
and 1e-3 per tensor (two frameworks' float32 gradients through the model,
normalized by Adam: a zero-initialized bias is all update),
drop-path 0 on both sides (the port's drop-path generator cannot draw
``jax.random``'s bits).
"""

import functools
import logging
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.data import DataLoader as JaxLoader
from cswin_unet_tpu.data import RandomGenerator as JaxRandomGenerator
from cswin_unet_tpu.data import SynapseDataset as JaxDataset
from cswin_unet_tpu.data import make_synthetic_dataset as jax_make_synthetic
from cswin_unet_tpu.data.datasets import Subset as JaxSubset
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.train import continual as jax_continual
from cswin_unet_tpu.train import surgical as jax_surgical
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch import universal_test, universal_train
from cswin_unet_tpu_torch import finetune
from cswin_unet_tpu_torch.data import (DataLoader, RandomGenerator, Subset, SynapseDataset,
                                       make_synthetic_dataset)
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.train import continual, surgical
from cswin_unet_tpu_torch.utils import checkpoint as port_ckpt

torch.set_num_threads(2)

SMALL = dict(img_size=32, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 1),
             num_heads=(2, 2, 4, 8))
TINY_YAML = ("MODEL:\n  TYPE: cswin\n  NAME: cswin_test_tiny\n  DROP_PATH_RATE: 0.1\n"
             "  PRETRAIN_CKPT: \"\"\n  CSWIN:\n    EMBED_DIM: 16\n"
             "    DEPTH: [1, 1, 1, 1]\n    NUM_HEADS: [2, 2, 4, 8]\n"
             "    SPLIT_SIZE: [1, 2, 2, 1]\n")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@functools.cache
def _jax_pair(num_classes, seed=0):
    jm = JaxCSwinUnet(backbone=JaxCSWinUNet(num_classes=num_classes, **SMALL))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                             jnp.zeros((1, 32, 32, 1))))
    return jm, params


def _port_model(params, num_classes, drop_path_rate=0.0):
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(params).items()}
    backbone = CSWinUNet(num_classes=num_classes, dtype=torch.float32,
                         drop_path_rate=drop_path_rate, **SMALL)
    backbone.load_state_dict(port_ckpt.params_from_jax(flat))
    return CSwinUnet(backbone)


@pytest.fixture(scope="module")
def kits(tmp_path_factory):
    """A KiTS-like set (labels 0..3) written by both packages' generators."""
    root = tmp_path_factory.mktemp("kits")
    kw = dict(num_train_slices=12, num_volumes=1, size=48, depth=4, num_classes=4, seed=2)
    port = make_synthetic_dataset(str(root / "port"), **kw)
    ref = jax_make_synthetic(str(root / "jax"), **kw)
    assert port["train_names"] == ref["train_names"]
    for name in port["train_names"]:
        with np.load(os.path.join(port["train_dir"], name + ".npz")) as a, \
                np.load(os.path.join(ref["train_dir"], name + ".npz")) as b:
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
    return port


def test_expand_classifier_detect_and_find_match_jax(tmp_path):
    """New head rows equal JAX's bit for bit (drawn in HWIO, moved to OIHW);
    ``detect_num_classes`` and ``find_checkpoint`` answer as JAX's on the
    same files."""
    _, params = _jax_pair(9)
    state = _port_model(params, 9).cswin_unet.state_dict()
    grown = port_ckpt.expand_classifier(state, 12, seed=3)
    want = jax_ckpt.flatten(jax_ckpt._backbone_of(
        jax_ckpt.expand_classifier(params, 12, seed=3)))["output/kernel"]
    got = grown["output.weight"].numpy().transpose(2, 3, 1, 0)
    assert got.shape == want.shape == (1, 1, 16, 12)
    np.testing.assert_array_equal(got, want)
    assert all(torch.equal(grown[k], v) for k, v in state.items() if k != "output.weight")
    with pytest.raises(ValueError):
        port_ckpt.expand_classifier(state, 9)

    d = tmp_path / "run"
    d.mkdir()
    jax_ckpt.save_checkpoint(str(d / "continual_surgical_tpgm_stage1_epoch_0.npz"), params)
    port_ckpt.save_checkpoint(str(d / "continual_surgical_tpgm_stage1_final.npz"), grown)
    torch.save({"model": {"module.output.weight": grown["output.weight"]}},
               str(tmp_path / "ref.pth"))
    for path in (d / "continual_surgical_tpgm_stage1_epoch_0.npz",
                 d / "continual_surgical_tpgm_stage1_final.npz", tmp_path / "ref.pth"):
        assert (port_ckpt.detect_num_classes(str(path))
                == jax_ckpt.detect_num_classes(str(path)))
    assert port_ckpt.detect_num_classes(str(tmp_path / "ref.pth")) == 12
    for path in (d, d / "continual_surgical_tpgm_stage1_epoch_0.npz"):
        assert port_ckpt.find_checkpoint(str(path)) == jax_ckpt.find_checkpoint(str(path))
    assert port_ckpt.find_checkpoint(str(d)).endswith("_final.npz")
    with pytest.raises(FileNotFoundError):
        port_ckpt.find_checkpoint(str(tmp_path / "missing"))


def test_stage_info_and_label_map():
    a = types.SimpleNamespace(stage=1, num_classes_old=9, num_classes_new=4,
                              num_classes_lits17=3, dataset="kits23")
    assert continual.get_stage_info(a) == jax_continual.get_stage_info(a) == (9, 4, 12,
                                                                              "kits23")
    a.stage, a.num_classes_old = 2, 12
    assert continual.get_stage_info(a) == jax_continual.get_stage_info(a) == (12, 3, 14,
                                                                              "lits17")
    labels = np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.int32)
    for stage, old in ((1, 9), (2, 12)):
        want = jax_continual.map_new_dataset_labels(labels, stage, old)
        np.testing.assert_array_equal(continual.map_new_dataset_labels(labels, stage, old),
                                      want)
        got = continual.map_new_dataset_labels(torch.from_numpy(labels), stage, old)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stage,old,total", [(1, 9, 12), (2, 12, 14)])
def test_continual_loss_matches_jax(stage, old, total):
    """(1−w)·(0.2·focal + 0.8·Dice) + w·KD with class weights: the value,
    its parts, and the gradient with respect to the student's logits."""
    rng = np.random.default_rng(stage)
    logits = rng.normal(size=(2, 8, 8, total)).astype(np.float32) * 2
    old_logits = rng.normal(size=(2, 8, 8, old)).astype(np.float32)
    labels = rng.integers(0, 4 if stage == 1 else 3, (2, 8, 8)).astype(np.int32)
    cw = rng.uniform(0.1, 1.5, total).astype(np.float32)
    kw = dict(kd_weight=0.3, kd_temperature=3.0, class_weights=cw)
    mapped = jax_continual.map_new_dataset_labels(labels, stage, old)
    jfn = jax_continual.make_continual_loss(total, old, **kw)
    (jtotal, jaux), jgrad = jax.value_and_grad(
        lambda lo: jfn(lo, jnp.asarray(old_logits), jnp.asarray(mapped)),
        has_aux=True)(jnp.asarray(logits))
    fn = continual.make_continual_loss(total, old, **kw)
    t = torch.from_numpy(logits).requires_grad_()
    total_t, aux = fn(t, torch.from_numpy(old_logits), torch.from_numpy(mapped))
    (grad,) = torch.autograd.grad(total_t, t)
    for k in ("loss", "loss_ce", "loss_dice", "loss_kd"):  # KD sums pixels: ~40
        assert float(aux[k].detach()) == pytest.approx(float(jaux[k]), rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(jgrad)).max()) > 1e-4


def test_positive_sampling_batches_equal_jax(kits):
    """``Subset`` + ``PositiveSamplingDataset`` + the loader: the port's
    batches equal JAX's for two epochs."""
    kw = dict(base_dir=kits["train_dir"], list_dir=kits["list_dir"], split="train")
    idx = np.random.default_rng(7).choice(12, 9, replace=False).tolist()
    port = continual.PositiveSamplingDataset(
        Subset(SynapseDataset(transform=RandomGenerator([32, 32]), **kw), idx), seed=4)
    ref = jax_continual.PositiveSamplingDataset(
        JaxSubset(JaxDataset(transform=JaxRandomGenerator([32, 32]), **kw), idx), seed=4)
    assert port.class_indices == ref.class_indices and len(port.class_indices[3]) > 0
    pl = DataLoader(port, 4, seed=5, num_workers=2)
    jl = JaxLoader(ref, 4, seed=5, num_workers=2)
    for _ in range(2):
        for a, b in zip(pl, jl, strict=True):
            assert a["case_name"] == b["case_name"]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("n", [1, 5, 11, 12, 13, 30])
def test_epoch_indices_against_jax_loader(n):
    """Equal to the JAX loader's wherever the dataset holds half a batch
    (n >= 12 at bs 24); below that the JAX loader yields one short batch of
    2n samples and the port a full batch, wrapping the epoch further."""
    ds = list(range(n))
    port = DataLoader(ds, 24, seed=3)
    ref = JaxLoader(ds, 24, seed=3)
    got, want = port._epoch_indices(), ref._epoch_indices()
    assert len(got) % 24 == 0 and len(got) == 24 * -(-n // 24)
    if n >= 12:
        np.testing.assert_array_equal(got, want)
    else:
        assert len(want) == 2 * n
        np.testing.assert_array_equal(got, np.resize(want[:n], 24))


def test_continual_step_matches_jax():
    """One continual step at drop-path 0: the teacher (4 classes) without
    gradients, the student (7), the continual loss and one surgical AdamW
    update with non-uniform and zero weights."""
    jt, tparams = _jax_pair(4, seed=0)
    js, _ = _jax_pair(7, seed=1)
    sparams = jax_ckpt.expand_classifier(tparams, 7, seed=0)
    rng = np.random.default_rng(9)
    image = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    label = rng.integers(0, 4, (2, 32, 32)).astype(np.int32)
    cw = rng.uniform(0.2, 1.2, 7).astype(np.float32)
    flat = jax_ckpt.flatten(sparams)
    jw = {k: float(rng.uniform(0, 1)) * (i % 7 != 0) for i, k in enumerate(sorted(flat))}
    kw = dict(kd_weight=0.2, kd_temperature=3.0, class_weights=cw)

    jopt = jax_surgical.SurgicalOptimizer(1e-3, 2)
    jstep = jax_continual.make_continual_train_step(
        js, jt, jopt, jax_continual.make_continual_loss(7, 4, **kw), 1, 4)
    new, _, jaux = jstep(sparams, tparams, jopt.init(sparams),
                         jax_surgical.weight_tree(sparams, jw), jnp.asarray(0.0),
                         jnp.asarray(image), jnp.asarray(label), jax.random.PRNGKey(0))
    want = port_ckpt.params_from_jax({k: np.asarray(v) for k, v in
                                      jax_ckpt.flatten(jax.device_get(new)).items()})

    teacher = _port_model(tparams, 4).eval()
    student = _port_model(sparams, 7).train()
    params = surgical.backbone_params(student)
    weights = {k: jw[surgical.jax_name(k, v.ndim)] for k, v in params.items()}
    opt = surgical.SurgicalOptimizer(params, 1e-3, 2)
    step = continual.make_continual_train_step(
        student, teacher, opt, continual.make_continual_loss(7, 4, **kw), 1, 4)
    aux = step(torch.from_numpy(image), torch.from_numpy(label), weights, 0, None)
    assert abs(float(aux["loss"]) - float(jaux["loss"])) <= 1e-4 * abs(float(jaux["loss"]))
    got = np.concatenate([p.detach().numpy().ravel() for p in params.values()])
    assert _rel_l2(got, np.concatenate([want[k].numpy().ravel() for k in params])) <= 1e-4
    before = port_ckpt.params_from_jax({k: np.asarray(v) for k, v in flat.items()})
    moved = 0
    for k, p in params.items():
        # a zero-initialized bias is all update, and Adam's first update
        # g / (|g| + 1e-8) moves with the last bits of a tiny gradient
        assert _rel_l2(p.detach().numpy(), want[k].numpy()) <= 1e-3, k
        if weights[k]:
            moved += not torch.equal(p.detach(), before[k])
        else:
            assert torch.equal(p.detach(), before[k]), k
    assert moved > len(params) // 2


@pytest.mark.parametrize("auto_tune,disable_tpgm", [("RGN", False), ("none", True)])
def test_continual_master_loop(tmp_path, kits, auto_tune, disable_tpgm):
    """``trainer_continual_surgical_tpgm`` at the JAX e2e test's shapes and
    settings: the final checkpoint loads with JAX's loader, its head has 7
    classes, every value is finite, and TPGM writes its ratio log."""
    old_classes, total = 4, 7
    _, params = _jax_pair(old_classes)
    teacher = _port_model(params, old_classes).eval()
    student = _port_model(jax_ckpt.expand_classifier(params, total, seed=0), total,
                          drop_path_rate=0.1).train()
    args = types.SimpleNamespace(
        stage=1, dataset="kits23", num_classes_old=old_classes, num_classes_new=4,
        num_classes_lits17=3, root_path=kits["train_dir"], list_dir=kits["list_dir"],
        img_size=32, batch_size=4, n_gpu=1, seed=1234, base_lr=1e-3, max_epochs=2,
        data_fraction=1.0, kd_temperature=3.0, kd_weight=0.2, auto_tune=auto_tune,
        gradient_batches=2, tpgm_norm_mode="l2", tpgm_lr=0.05, tpgm_iters=4,
        tpgm_exclude=[], tpgm_frequency=1, tpgm_start_epoch=0, disable_tpgm=disable_tpgm,
        tpgm_data_fraction=0.5, device="cpu")
    out = tmp_path / "out"
    msg = continual.trainer_continual_surgical_tpgm(
        args, student, teacher, str(out), (old_classes, 4, total, "kits23"))
    assert "Finished" in msg
    final = out / "continual_surgical_tpgm_stage1_final.npz"
    assert final.exists() and (out / "continual_surgical_tpgm_stage1_epoch_1.npz").exists()
    tree, _ = jax_ckpt.load_checkpoint(str(final))
    flat = jax_ckpt.flatten(jax_ckpt._backbone_of(tree))
    assert flat["output/kernel"].shape[-1] == total
    assert all(np.isfinite(v).all() for v in flat.values())
    ratios = (out / "tpgm_ratios.log").read_text()
    log = (out / "log.txt").read_text()
    if disable_tpgm:
        assert "Enabled: False" in ratios and "Applying final TPGM projection" not in log
    else:
        assert "Enabled: True" in ratios and "ratio output.weight: " in ratios
        assert log.count("TPGM optimization complete. Average constraint change:") == 2
        assert "Applying final TPGM projection" in log
    assert (log.count("Calculating gradient weights for surgical fine-tuning")
            == (2 if auto_tune == "RGN" else 0))
    logging.getLogger().handlers.clear()


def _yaml(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    return str(cfg)


def test_universal_cli_stages_and_test(tmp_path, kits):
    """Stage 1 (9 -> 12) from a 9-class checkpoint, stage 2 (12 -> 14) from
    stage 1's final checkpoint on a LiTS-like set, ``universal_test`` of the
    stage-2 checkpoint on KiTS23 with the reference's log lines, and a
    stage-1 checkpoint refused for LiTS17."""
    cfg = _yaml(tmp_path)
    _, params = _jax_pair(9)
    teacher = str(tmp_path / "synapse.npz")
    jax_ckpt.save_checkpoint(teacher, params)
    lits = make_synthetic_dataset(str(tmp_path / "lits"), num_train_slices=8, num_volumes=0,
                                  size=40, num_classes=3, seed=6)
    common = ["--cfg", cfg, "--img_size", "32", "--batch_size", "4", "--gradient_batches",
              "2", "--tpgm_iters", "2", "--tpgm_start_epoch", "0", "--tpgm_frequency", "1",
              "--tpgm_data_fraction", "0.5", "--device", "cpu"]
    s1, s2 = tmp_path / "s1", tmp_path / "s2"
    assert "Finished" in universal_train.main(
        ["--stage", "1", "--pretrained_path", teacher, "--root_path", kits["train_dir"],
         "--list_dir", kits["list_dir"], "--output_dir", str(s1), "--max_epochs", "2",
         *common])
    final1 = s1 / "continual_surgical_tpgm_stage1_final.npz"
    assert port_ckpt.detect_num_classes(str(final1)) == 12
    assert "Finished" in universal_train.main(
        ["--stage", "2", "--num_classes_old", "12", "--pretrained_path", str(final1),
         "--root_path", lits["train_dir"], "--list_dir", lits["list_dir"],
         "--output_dir", str(s2), "--max_epochs", "1", *common])
    assert jax_ckpt.detect_num_classes(
        str(s2 / "continual_surgical_tpgm_stage2_final.npz")) == 14

    out = tmp_path / "test"
    dice, hd95 = universal_test.main(
        ["--cfg", cfg, "--volume_path", kits["vol_dir"], "--list_dir", kits["list_dir"],
         "--test_dataset", "kits23", "--model_path", str(s2), "--output_dir", str(out),
         "--img_size", "32", "--device", "cpu"])
    lines = (out / "test_kits23.txt").read_text().splitlines()
    assert any(re.search(r"idx 0 case case0100 mean_dice \d+\.\d{6} mean_hd95 \d+\.\d{6}$", x)
               for x in lines)
    assert sum(bool(re.search(r"Mean class [123] mean_dice ", x)) for x in lines) == 3
    assert any(x.endswith(f"Testing performance in best val model: mean_dice : "
                          f"{dice:f} mean_hd95 : {hd95:f}") for x in lines)
    with pytest.raises(RuntimeError, match="cannot evaluate lits17"):
        universal_test.main(["--cfg", cfg, "--volume_path", kits["vol_dir"],
                             "--test_dataset", "lits17", "--model_path", str(s1),
                             "--output_dir", str(out), "--img_size", "32", "--device",
                             "cpu"])
    logging.getLogger().handlers.clear()


def test_clis_refuse_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _yaml(tmp_path)
    for main, argv in (
            (finetune.main, ["--cfg", cfg, "--output_dir", str(tmp_path)]),
            (universal_train.main, ["--cfg", cfg, "--pretrained_path", "x.npz",
                                    "--output_dir", str(tmp_path)]),
            (universal_test.main, ["--cfg", cfg, "--volume_path", ".", "--test_dataset",
                                   "kits23", "--model_path", ".", "--output_dir",
                                   str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
