"""``python -m cswin_unet_tpu_torch.tools.apply_blur`` against the root blur
tools (``tools/apply_blur_train.py``, ``tools/apply_blur_test.py``, which
run the JAX package's scipy path) on a small synthetic set.

Tolerance: images within 1e-5 (absolute, on values of order 1); labels, file
names, ``train.txt``, the ``.h5`` datasets' names, compression and chunking
and the files' attrs equal.
"""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from cswin_unet_tpu.data import make_synthetic_dataset
from cswin_unet_tpu_torch.tools import apply_blur

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(script, *argv):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", script), *argv],
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("blurdata")
    d = make_synthetic_dataset(str(root), num_train_slices=5, num_volumes=2, size=40,
                               depth=3, num_classes=3, seed=4)
    rng = np.random.default_rng(5)
    # a slice whose label is stored as "segmentation", and a volume with
    # attrs, gzip and chunks
    np.savez(os.path.join(d["train_dir"], "case9999_slice000.npz"),
             image=rng.standard_normal((40, 40)).astype(np.float32),
             segmentation=rng.integers(0, 3, (40, 40)).astype(np.uint8))
    with h5py.File(os.path.join(d["vol_dir"], "case9999.npy.h5"), "w") as f:
        f.attrs["spacing"] = np.array([0.7, 0.7, 2.5])
        f.attrs["case"] = "case9999"
        f.create_dataset("image", data=rng.standard_normal((4, 40, 40)).astype(np.float32),
                         compression="gzip", chunks=(1, 40, 40))
        f.create_dataset("label", data=rng.integers(0, 3, (4, 40, 40)).astype(np.uint8),
                         compression="gzip", chunks=(1, 40, 40))
    return d


def test_train_mode_matches_the_root_tool(data, tmp_path):
    outs = {}
    for who in ("root", "port"):
        out, lists, samples = (str(tmp_path / who / n) for n in ("npz", "lists", "samples"))
        argv = ["--input_dir", data["train_dir"], "--output_dir", out, "--list_output_dir",
                lists, "--sample_dir", samples, "--num_samples", "1"]
        if who == "root":
            _root_tool("apply_blur_train.py", *argv)
        else:
            assert len(apply_blur.main(["train", *argv, "--device", "cpu"])) == 6
        outs[who] = (out, lists, samples)
    (r_out, r_lists, r_samples), (p_out, p_lists, p_samples) = outs["root"], outs["port"]
    assert sorted(os.listdir(r_out)) == sorted(os.listdir(p_out))
    assert sorted(os.listdir(r_samples)) == sorted(os.listdir(p_samples)) == ["sample_0.png"]
    with open(os.path.join(r_lists, "train.txt")) as a, open(os.path.join(p_lists,
                                                                          "train.txt")) as b:
        assert a.read() == b.read()
    for fname in os.listdir(r_out):
        r, p = np.load(os.path.join(r_out, fname)), np.load(os.path.join(p_out, fname))
        assert sorted(r.files) == sorted(p.files) == ["image", "label"]
        assert p["image"].dtype == np.float32
        np.testing.assert_allclose(p["image"], r["image"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(p["label"], r["label"])
        assert p["label"].dtype == r["label"].dtype


def test_test_mode_matches_the_root_tool(data, tmp_path):
    outs = {}
    for who in ("root", "port"):
        out, samples = str(tmp_path / who / "h5"), str(tmp_path / who / "samples")
        argv = ["--input_dir", data["vol_dir"], "--output_dir", out, "--sample_dir",
                samples, "--num_samples", "2"]
        if who == "root":
            _root_tool("apply_blur_test.py", *argv)
        else:
            apply_blur.main(["test", *argv, "--device", "cpu"])
        outs[who] = (out, samples)
    (r_out, r_samples), (p_out, p_samples) = outs["root"], outs["port"]
    names = sorted(os.listdir(r_out))
    assert names == sorted(os.listdir(p_out)) and len(names) == 3
    assert sorted(os.listdir(r_samples)) == sorted(os.listdir(p_samples))
    for fname in names:
        with h5py.File(os.path.join(r_out, fname), "r") as r, \
                h5py.File(os.path.join(p_out, fname), "r") as p:
            assert dict(r.attrs).keys() == dict(p.attrs).keys()
            for k in r.attrs:
                np.testing.assert_array_equal(p.attrs[k], r.attrs[k])
            assert sorted(r) == sorted(p)
            for name in r:
                assert (p[name].compression, p[name].chunks, p[name].dtype) == (
                    r[name].compression, r[name].chunks, r[name].dtype), name
                if name in ("image", "images"):
                    np.testing.assert_allclose(p[name][:], r[name][:], rtol=0, atol=1e-5)
                else:
                    np.testing.assert_array_equal(p[name][:], r[name][:])


def test_no_figures_needs_no_matplotlib(data, tmp_path):
    """``--num_samples 0``: no figure and no import of matplotlib; the
    ``train`` mode imports no h5py and nothing of JAX."""
    guard = (
        "import importlib.abc, sys\n"
        "class G(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('matplotlib', 'h5py', 'jax', 'flax',\n"
        "                                  'cswin_unet_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, G())\n"
        "from cswin_unet_tpu_torch.tools.apply_blur import main\n"
        f"main(['train', '--input_dir', {data['train_dir']!r}, '--output_dir', "
        f"{str(tmp_path / 'npz')!r}, '--list_output_dir', {str(tmp_path / 'lists')!r}, "
        f"'--sample_dir', {str(tmp_path / 'samples')!r}, '--num_samples', '0', "
        "'--device', 'cpu'])\n")
    res = subprocess.run([sys.executable, "-c", guard], cwd=REPO, capture_output=True,
                         text=True, timeout=180, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    assert len(os.listdir(tmp_path / "npz")) == 6 and not (tmp_path / "samples").exists()
