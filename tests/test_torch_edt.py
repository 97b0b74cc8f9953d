"""The port's device metrics (``ops/edt.py``) on the CPU against the JAX
``ops/edt.py`` (Pallas ``edt_pass`` in interpret mode), scipy and the host
metrics.

Tolerances: the 1-D pass is bit for bit (the same float32 sums, and min is
exact); EDT against scipy as the JAX package's own test (rtol 1e-5, atol
1e-3 on squared distances); boundaries and the nearest zoom exactly;
(dice, hd95) within rtol 1e-5 and atol 1e-4 (the JAX package's tolerance,
``tests/test_edt.py:71,88``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cswin_unet_tpu.ops import edt as jax_edt
from cswin_unet_tpu_torch import metrics
from cswin_unet_tpu_torch.ops import edt
from cswin_unet_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(2)

SHAPES = [(6, 24, 24), (1, 40, 40), (5, 17, 33)]


def _blob(rng, shape, p=0.2, smooth=1.2):
    x = ndimage.gaussian_filter(rng.standard_normal(shape), smooth)
    return x > np.quantile(x, 1 - p)


def _seed_field(rng, shape):
    """+inf (1e12) off the seeds, seeds at 0 or at a random partial sum (a
    pass after the first sees finite values)."""
    f = np.where(rng.random(shape) < 0.1, 0.0, 1e12).astype(np.float32)
    part = rng.random(shape) < 0.1
    f[part] = rng.uniform(0, 300, part.sum()).astype(np.float32)
    return f


@pytest.mark.parametrize("shape", SHAPES)
def test_edt_pass_plain_bit_for_bit_with_pallas(shape):
    f = _seed_field(np.random.default_rng(0), shape)
    for ax in range(3):
        want = np.moveaxis(np.asarray(jax_edt.edt_pass(
            jnp.asarray(np.moveaxis(f, ax, -1)), interpret=True)), -1, ax)
        for fn in (K.edt_pass_plain, K.edt_pass):
            got = fn(torch.from_numpy(f), ax)
            assert got.is_contiguous() and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    assert K.edt_pass.launches == 0  # CPU tensors run the plain version


def test_edt_pass_plain_chunks_long_lines():
    """Lines of 512 (the 512² CT slices) go in several chunks."""
    f = _seed_field(np.random.default_rng(1), (300, 512))
    want = np.asarray(jax_edt.edt_pass(jnp.asarray(f), interpret=True))
    np.testing.assert_array_equal(K.edt_pass_plain(torch.from_numpy(f)).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_edt_sq_matches_scipy_and_jax(shape):
    seeds = _blob(np.random.default_rng(0), shape, p=0.05)
    if not seeds.any():
        seeds.flat[0] = True
    got = edt.edt_sq(torch.from_numpy(seeds)).numpy()
    want = ndimage.distance_transform_edt(~seeds) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        got, np.asarray(jax_edt.edt_sq(jnp.asarray(seeds), interpret=True)))


def test_edt_sq_without_seeds_stays_inf():
    got = edt.edt_sq(torch.zeros(3, 4, 5, dtype=torch.bool))
    assert float(got.min()) >= 9.9e11


@pytest.mark.parametrize("shape", [(7, 30, 30), (1, 8, 8), (4, 1, 9)])
def test_boundary_matches_scipy(shape):
    m = _blob(np.random.default_rng(1), shape, p=0.3) if min(shape) > 1 else \
        np.ones(shape, bool)
    conn = ndimage.generate_binary_structure(3, 1)
    want = m ^ ndimage.binary_erosion(m, structure=conn, iterations=1)
    np.testing.assert_array_equal(edt.boundary(torch.from_numpy(m)).numpy(), want)


@pytest.mark.parametrize("in_hw,out_hw", [((224, 224), (512, 512)),
                                          ((224, 224), (224, 224)),
                                          ((224, 224), (100, 317)),
                                          ((37, 53), (61, 29)), ((1, 9), (5, 1))])
def test_zoom_nearest_matches_scipy(in_hw, out_hw):
    x = np.random.default_rng(5).integers(0, 9, size=(3, *in_hw)).astype(np.int32)
    want = np.stack([ndimage.zoom(s, (out_hw[0] / in_hw[0], out_hw[1] / in_hw[1]),
                                  order=0) for s in x])
    got = edt.zoom_nearest(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hd95_pair_matches_host(seed):
    rng = np.random.default_rng(seed)
    pred, gt = _blob(rng, (5, 28, 28), 0.25), _blob(rng, (5, 28, 28), 0.25)
    got = float(edt.hd95_pair(torch.from_numpy(pred), torch.from_numpy(gt)))
    np.testing.assert_allclose(got, metrics.hd95(pred, gt), rtol=1e-5, atol=1e-4)


def _cases():
    rng = np.random.default_rng(3)
    label = rng.integers(0, 3, size=(4, 20, 20)).astype(np.int32)
    pred = label.copy()
    # class 1: imperfect overlap; 2: equal; 3: pred only -> (1, 0); 4: gt
    # only -> (0, 0); 5: absent everywhere -> (0, 0)
    pred[label == 1] = np.where(rng.random((label == 1).sum()) < 0.8, 1, 0)
    pred[0, 0, :3] = 3
    label[3, 5:9, 5:9] = 4
    blobs = np.zeros((6, 40, 40), np.int32)
    b = np.random.default_rng(4)
    blobs[_blob(b, blobs.shape, 0.2)] = 1
    blobs[_blob(b, blobs.shape, 0.1)] = 2
    pb = blobs.copy()
    pb[_blob(b, blobs.shape, 0.05)] = 2
    return [(pred, label, 6), (pb, blobs, 3),
            (np.zeros((3, 16, 16), np.int32), np.zeros((3, 16, 16), np.int32), 3)]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_volume_metrics_device_matches_jax_and_host(case):
    pred, label, nc = _cases()[case]
    got = edt.volume_metrics_device(torch.from_numpy(pred), torch.from_numpy(label), nc)
    assert got.shape == (nc - 1, 2) and got.dtype == torch.float64
    host = np.array(metrics.volume_metrics(pred, label, nc))
    ref = np.asarray(jax_edt.volume_metrics_device(jnp.asarray(pred), jnp.asarray(label),
                                                   nc, interpret=True))
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
