"""The port's evaluation slice against the JAX package: ``test_single_volume``
on the host-metrics and device-metrics routes, the ``inference`` log lines,
and the eval CLI on an ``.npy.h5`` dataset with a checkpoint written by the
port's trainer.

The model is test_torch_serve.py's SMALL geometry in float32, weights from
a JAX init carried over with ``params_from_jax``. Tolerances: labels equal
(float32 forwards of the same weights; checked first, so a metric mismatch
cannot hide behind a label flip); host metrics equal; device metrics within
rtol 1e-5 and atol 1e-4 of the host's (the JAX package's tolerance,
``tests/test_edt.py:71,88``).
"""

import argparse
import importlib
import logging
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cswin_unet_tpu.data import make_synthetic_dataset
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu.utils.flops import clever_format, count_params
from cswin_unet_tpu_torch.eval import inference as port_eval
from cswin_unet_tpu_torch.eval.__main__ import main as eval_main
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.train.__main__ import main as train_main
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

# the JAX package's ``eval`` exports a function of the module's name
jax_eval = importlib.import_module("cswin_unet_tpu.eval.inference")

SMALL = dict(img_size=32, num_classes=4, embed_dim=16, depth=(1, 1, 1, 1),
             split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))
TINY_YAML = ("MODEL:\n  TYPE: cswin\n  NAME: cswin_test_tiny\n  DROP_PATH_RATE: 0.1\n"
             "  PRETRAIN_CKPT: \"\"\n  CSWIN:\n    EMBED_DIM: 16\n"
             "    DEPTH: [1, 1, 1, 1]\n    NUM_HEADS: [2, 2, 4, 8]\n"
             "    SPLIT_SIZE: [1, 2, 2, 1]\n")
MEAN_CLASS = re.compile(r"^Mean class (\d+) mean_dice (\d+\.\d{6}) mean_hd95 (\d+\.\d{6})$")


@pytest.fixture(scope="module")
def models():
    jm = JaxCSwinUnet(backbone=JaxCSWinUNet(**SMALL, attn_impl="xla"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}
    backbone = CSWinUNet(**SMALL, dtype=torch.float32)
    backbone.load_state_dict(params_from_jax(flat))
    return (jm, params), CSwinUnet(backbone).eval()


def _volume(seed, depth, size, nc):
    """A CT-like volume: blob labels 0..nc-1, intensity tracking the label."""
    rng = np.random.default_rng(seed)
    label = np.zeros((depth, size, size), np.uint8)
    for c in range(1, nc):
        x = ndimage.gaussian_filter(rng.standard_normal(label.shape), 2.0)
        label[x > np.quantile(x, 0.85)] = c
    image = (label * 0.4 + rng.normal(0, 0.3, label.shape)).astype(np.float32)
    return image, label


@pytest.mark.parametrize("size", [48, 32])
def test_single_volume_both_routes_match_jax(models, size):
    (jm, params), port = models
    image, label = _volume(0, 5, size, 4)
    jinf = jax_eval.VolumeInferencer(jm, params, patch_size=(32, 32), batch_slices=8,
                                     data_parallel=False)
    pinf = port_eval.VolumeInferencer(port, device="cpu", patch_size=(32, 32),
                                      batch_slices=8)
    slices = np.stack([ndimage.zoom(s, (32 / size, 32 / size), order=3)
                       for s in image]).astype(np.float32)
    np.testing.assert_array_equal(pinf.predict_slices(slices),
                                  jinf.predict_slices(slices))
    dev = pinf.predict_slices_device(slices)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), pinf.predict_slices(slices))

    kw = dict(classes=4, patch_size=(32, 32))
    host = port_eval.test_single_volume(image, label, pinf, **kw)
    assert host == jax_eval.test_single_volume(image, label, jinf, **kw)
    device = port_eval.test_single_volume(image, label, pinf, device_metrics=True, **kw)
    jdevice = jax_eval.test_single_volume(image, label, jinf, device_metrics=True, **kw)
    np.testing.assert_allclose(device, host, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(device, jdevice, rtol=1e-5, atol=1e-4)
    assert K.edt_pass.launches == 0  # CPU: the kernels' plain versions


def test_single_volume_device_metrics_on_real_overlap(models, monkeypatch):
    """The device route scores the labels the inferencer returns: feed it
    noisy ground truth (so every class has real Dice and HD95) and hold it
    against the host route on the same labels."""
    _, port = models
    image, label = _volume(1, 6, 40, 4)
    noisy = label.astype(np.int32).copy()
    rng = np.random.default_rng(2)
    noisy[rng.random(noisy.shape) < 0.05] = 2
    noisy[:, :3] = 3

    inf = port_eval.VolumeInferencer(port, device="cpu", patch_size=(40, 40))
    monkeypatch.setattr(inf, "predict_slices", lambda s: noisy.copy())
    monkeypatch.setattr(inf, "predict_slices_device", lambda s: torch.from_numpy(noisy))
    kw = dict(classes=5, patch_size=(40, 40))
    host = port_eval.test_single_volume(image, label, inf, **kw)
    device = port_eval.test_single_volume(image, label, inf, device_metrics=True, **kw)
    assert all(0 < d < 1 and h > 0 for d, h in host[:3]) and host[3] == (0.0, 0.0)
    np.testing.assert_allclose(device, host, rtol=1e-5, atol=1e-4)


def test_single_volume_falls_back_to_host_for_2d_and_nifti(models, tmp_path):
    _, port = models
    image, label = _volume(3, 3, 32, 4)
    inf = port_eval.VolumeInferencer(port, device="cpu", patch_size=(32, 32))
    out = port_eval.test_single_volume(image, label, inf, classes=4,
                                       patch_size=(32, 32), device_metrics=True,
                                       test_save_path=str(tmp_path), case="c7")
    assert out == port_eval.test_single_volume(image, label, inf, classes=4,
                                               patch_size=(32, 32))
    assert sorted(os.listdir(tmp_path)) == ["c7_gt.nii.gz", "c7_img.nii.gz",
                                            "c7_pred.nii.gz"]
    one = port_eval.test_single_volume(image[1], label[1], inf, classes=4,
                                       patch_size=(32, 32), device_metrics=True)
    assert len(one) == 3


def _log_lines(caplog):
    return [r.getMessage() for r in caplog.records]


def test_inference_log_lines_match_jax(models, caplog, tmp_path):
    (jm, params), port = models
    db = [dict(zip(("image", "label"), _volume(s, 4, 48, 4)), case_name=f"case{s:04d}")
          for s in (5, 6)]
    args = argparse.Namespace(num_classes=4, img_size=32, z_spacing=1,
                              device_metrics=False)
    pinf = port_eval.VolumeInferencer(port, device="cpu", patch_size=(32, 32))
    jinf = jax_eval.VolumeInferencer(jm, params, patch_size=(32, 32), data_parallel=False)
    runs = {}
    for name, mod, inf, vis in (("port", port_eval, pinf, tmp_path / "vis"),
                                ("jax", jax_eval, jinf, None)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            res = mod.inference(args, inf, db, visual_save_dir=vis and str(vis))
        runs[name] = (res, _log_lines(caplog))
    (res, lines), (jres, jlines) = runs["port"], runs["jax"]
    assert lines == jlines
    np.testing.assert_allclose(res, jres, rtol=1e-12)
    assert lines[0] == "2 test iterations per epoch"
    assert re.fullmatch(r"idx 0 case case0005 mean_dice \d+\.\d{6} mean_hd95 \d+\.\d{6}",
                        lines[1])
    assert [int(MEAN_CLASS.match(x)[1]) for x in lines[3:6]] == [1, 2, 3]
    assert re.fullmatch(r"Testing performance in best val model: mean_dice : "
                        r"\d+\.\d{6} mean_hd95 : \d+\.\d{6}", lines[6])
    assert sorted(os.listdir(tmp_path / "vis")) == ["case0005_slice_2.png",
                                                    "case0006_slice_2.png"]


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """An ``.npy.h5`` Synapse layout from the JAX ``make_synthetic_dataset``
    and ``run/epoch_0.npz`` from the port's training CLI, in a working
    directory of its own (the CLIs read ``./lists/...``)."""
    root = tmp_path_factory.mktemp("evalcli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ds = make_synthetic_dataset("synapse", num_train_slices=8, num_volumes=2,
                                    size=48, depth=3, num_classes=9, seed=0)
        for d in ("lists/lists_Synapse_blurred", "lists/lists_Synapse"):
            os.makedirs(d)
            for f in ("train.txt", "test_vol.txt"):
                shutil.copy(os.path.join(ds["list_dir"], f), d)
        (root / "tiny.yaml").write_text(TINY_YAML)
        train_main(["--cfg", "tiny.yaml", "--root_path", "synapse", "--dataset",
                    "Synapse", "--output_dir", "run", "--max_epochs", "1",
                    "--batch_size", "4", "--img_size", "32", "--device", "cpu",
                    "--num_workers", "2"])
    finally:
        os.chdir(cwd)
    assert (root / "run" / "epoch_0.npz").exists()
    return root


def _eval_cli(root, monkeypatch, capsys, *extra):
    monkeypatch.chdir(root)
    eval_main(["--cfg", "tiny.yaml", "--volume_path", "synapse", "--dataset", "Synapse",
               "--output_dir", "run", "--max_epochs", "1", "--img_size", "32",
               "--device", "cpu", *extra])
    logging.getLogger().handlers.clear()
    return capsys.readouterr().out.splitlines()


def test_eval_cli_reads_the_trainers_checkpoint(trained_run, monkeypatch, capsys):
    host = _eval_cli(trained_run, monkeypatch, capsys)
    assert host[0] == f"Loaded model from: {os.path.join('run', 'epoch_0.npz')}"
    assert sum(bool(re.match(r"idx \d case case010\d mean_dice ", x)) for x in host) == 2
    means = {int(m[1]): (float(m[2]), float(m[3]))
             for m in map(MEAN_CLASS.match, host) if m}
    assert sorted(means) == list(range(1, 9))
    assert any(x.startswith("Testing performance in best val model: ") for x in host)
    flops = [x for x in host if x.startswith("FLOPs: ")]
    assert len(flops) == 1 and re.fullmatch(r"FLOPs: \d+\.\d{3}[KMGT]?", flops[0])
    jm = JaxCSwinUnet(backbone=JaxCSWinUNet(img_size=32, num_classes=9, embed_dim=16,
                                            depth=(1, 1, 1, 1), split_size=(1, 2, 2, 1),
                                            num_heads=(2, 2, 4, 8)))
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    assert f"Params: {clever_format(count_params(jparams))}" in host
    assert os.path.exists(trained_run / "test_log" / "test_log_" / "log_Synapse.txt")
    assert len(os.listdir(trained_run / "test_visuals")) == 2

    device = _eval_cli(trained_run, monkeypatch, capsys, "--device_metrics")
    dmeans = {int(m[1]): (float(m[2]), float(m[3]))
              for m in map(MEAN_CLASS.match, device) if m}
    np.testing.assert_allclose([dmeans[c] for c in means], [means[c] for c in means],
                               rtol=1e-5, atol=1e-4)

    _eval_cli(trained_run, monkeypatch, capsys, "--device_metrics", "--is_savenii")
    assert len(os.listdir(trained_run / "run" / "predictions")) == 6  # pred/img/gt x 2


def test_eval_cli_cuda_without_gpu_raises(trained_run, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(trained_run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_main(["--cfg", "tiny.yaml", "--volume_path", "synapse",
                   "--output_dir", "run", "--max_epochs", "1"])
