"""Port's serving path against the JAX one on the same weights.

The model is test_serve.py's SMALL geometry (float32), weights from a JAX
init carried over with ``params_from_jax``. Labels are compared by
bench.py's margin rule: a mismatch counts only where the JAX model's top-2
logit gap exceeds 0.02·max|logit|.
"""

import gzip
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.eval.inference import VolumeInferencer as JaxInferencer
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.serve import VolumeServer as JaxServer
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.eval.inference import VolumeInferencer
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.serve import (VolumeServer, main, read_volume,
                                        watch_loop)
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax, save_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img_size=32, num_classes=4, embed_dim=16, depth=(1, 1, 1, 1),
             split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))


@pytest.fixture(scope="module")
def jax_model():
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**SMALL))
    params = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    return m, params


@pytest.fixture(scope="module")
def port_model(jax_model):
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(jax_model[1])).items()}
    backbone = CSWinUNet(**SMALL, dtype=torch.float32)
    backbone.load_state_dict(params_from_jax(flat))
    return CSwinUnet(backbone).eval()


@pytest.fixture(scope="module")
def server(port_model):
    s = VolumeServer(port_model, device="cpu", img_size=32, batch_slices=16)
    assert s.warmup() > 0
    return s


def _margin_mismatches(labels, ref_logits):
    srt = np.sort(ref_logits, -1)
    margin = srt[..., -1] - srt[..., -2]
    thr = 0.02 * float(np.abs(ref_logits).max())
    return int(np.sum((labels != ref_logits.argmax(-1)) & (margin > thr)))


def test_buckets_match_jax(port_model, jax_model):
    m, params = jax_model
    for bs in (4, 16, 32):
        ours = VolumeInferencer(port_model, device="cpu", batch_slices=bs)
        theirs = JaxInferencer(m, params, batch_slices=bs, data_parallel=False)
        assert ours._buckets == theirs._buckets


def test_segment_resizes_back(server):
    vol = np.random.default_rng(0).normal(size=(3, 48, 48)).astype(np.float32)
    pred = server.segment(vol)
    assert pred.shape == (3, 48, 48) and pred.dtype == np.int32
    assert pred.min() >= 0 and pred.max() < 4


def test_process_file_writes_nifti_and_stats(server, tmp_path):
    p = str(tmp_path / "case7.npz")
    vol = np.random.default_rng(1).normal(size=(3, 48, 48)).astype(np.float32)
    np.savez(p, image=vol)
    np.testing.assert_array_equal(read_volume(p), vol)
    stats = server.process_file(p, str(tmp_path / "out"))
    assert stats["case"] == "case7" and stats["slices"] == 3
    with gzip.open(stats["output"], "rb") as f:
        assert f.read(348)[344:347] == b"n+1"  # NIfTI-1 magic
    assert stats["slices_per_s"] > 0


@pytest.mark.parametrize("class_indices", [None, [0, 2]])
def test_labels_match_jax_server(port_model, jax_model, class_indices):
    """Same volume through both servers (9 slices: one padded 16-bucket
    chunk at batch_slices 16)."""
    m, params = jax_model
    vol = np.random.default_rng(2).normal(size=(9, 32, 32)).astype(np.float32)
    ours = VolumeServer(port_model, device="cpu", img_size=32, batch_slices=16,
                        class_indices=class_indices).segment(vol)
    theirs = JaxServer(m, params, img_size=32, batch_slices=16,
                       class_indices=class_indices).segment(vol)
    apply = jax.jit(lambda p, x: m.apply(p, x, deterministic=True))
    logits = np.asarray(apply(params, jnp.asarray(vol[..., None])), np.float32)
    if class_indices is not None:
        logits = logits[..., class_indices]
        assert ours.max() < len(class_indices)
    assert _margin_mismatches(ours, logits) == 0
    assert _margin_mismatches(theirs, logits) == 0


def test_watch_loop_drains_and_quarantines(server, tmp_path):
    watch = tmp_path / "incoming"
    watch.mkdir()
    np.savez(watch / "good.npz",
             image=np.random.default_rng(4).normal(size=(2, 32, 32)).astype(np.float32))
    (watch / "bad.npz").write_bytes(b"not a volume")
    lines = []
    n = watch_loop(server, str(watch), str(tmp_path / "out"), poll_s=0.01,
                   max_volumes=2, emit=lines.append)
    assert n == 2
    assert os.path.exists(watch / "done" / "good.npz")
    assert os.path.exists(watch / "failed" / "bad.npz")
    stats = [json.loads(line) for line in lines]
    assert any(s.get("case") == "good" for s in stats)
    assert stats[-1]["summary"]["volumes"] == 1


def test_cli_serves_a_checkpoint_on_cpu(port_model, tmp_path, capsys):
    cfg = tmp_path / "small.yaml"
    cfg.write_text("MODEL:\n  CSWIN:\n    EMBED_DIM: 16\n    DEPTH: [1, 1, 1, 1]\n"
                   "    NUM_HEADS: [2, 2, 4, 8]\n    SPLIT_SIZE: [1, 2, 2, 1]\n"
                   "TPU:\n  COMPUTE_DTYPE: float32\n")
    ck = save_checkpoint(str(tmp_path / "ck.npz"), port_model.cswin_unet.state_dict())
    vol = tmp_path / "v.npy"
    np.save(vol, np.random.default_rng(5).normal(size=(2, 32, 32)).astype(np.float32))
    main(["--cfg", str(cfg), "--checkpoint", ck, "--img_size", "32",
          "--num_classes", "4", "--device", "cpu", "--output_dir",
          str(tmp_path / "out"), str(vol)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["ready"] and lines[1]["case"] == "v"
    assert os.path.exists(tmp_path / "out" / "v_pred.nii.gz")


def test_cli_traces_the_first_volume(port_model, tmp_path, capsys):
    """``--trace_dir``: the first volume after the warm-up, read, segmented
    and written, is in ``trace.json`` with its spans; the second is not."""
    cfg = tmp_path / "small.yaml"
    cfg.write_text("MODEL:\n  CSWIN:\n    EMBED_DIM: 16\n    DEPTH: [1, 1, 1, 1]\n"
                   "    NUM_HEADS: [2, 2, 4, 8]\n    SPLIT_SIZE: [1, 2, 2, 1]\n"
                   "TPU:\n  COMPUTE_DTYPE: float32\n")
    ck = save_checkpoint(str(tmp_path / "ck.npz"), port_model.cswin_unet.state_dict())
    vols = [tmp_path / "a.npy", tmp_path / "b.npy"]
    for i, vol in enumerate(vols):
        np.save(vol, np.random.default_rng(6 + i).normal(size=(3, 32, 32)).astype(np.float32))
    main(["--cfg", str(cfg), "--checkpoint", ck, "--img_size", "32",
          "--num_classes", "4", "--device", "cpu", "--batch_slices", "8",
          "--output_dir", str(tmp_path / "out"), "--trace_dir", str(tmp_path / "trace"),
          *map(str, vols)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("case") for x in lines[1:]] == ["a", "b"]
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = [ev.get("name") for ev in events]
    for span in ("serve.read", "serve.segment", "serve.prepare", "infer.volume",
                 "infer.chunk", "infer.pad", "infer.copy_in", "infer.forward",
                 "infer.drain", "model.tail", "serve.finish", "serve.write"):
        assert names.count(span) == 1, span


def test_cli_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--cfg", os.path.join(REPO, "cswin_unet_tpu/configs/cswin_tiny_224_lite.yaml"),
              "--checkpoint", str(tmp_path / "none.npz"), str(tmp_path / "v.npy")])


def test_serve_module_imports_no_jax():
    code = ("import sys, cswin_unet_tpu_torch.serve, cswin_unet_tpu_torch.models, "
            "cswin_unet_tpu_torch.config, cswin_unet_tpu_torch.ops.cuda.build; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)
