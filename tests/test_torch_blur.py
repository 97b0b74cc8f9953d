"""The port's Gaussian blur (``ops/blur.py``) against the JAX package's
(``cswin_unet_tpu/ops/blur.py``) and ``scipy.ndimage.gaussian_filter``.

Tolerance: absolute 1e-5 on unit-variance float32 images (scipy sums in
float64, the port in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from cswin_unet_tpu.ops import blur as jax_blur
from cswin_unet_tpu_torch.ops import blur

torch.set_num_threads(2)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.5, 2.3])
def test_kernel_matches_jax(sigma):
    np.testing.assert_array_equal(blur.gaussian_kernel_1d(sigma),
                                  jax_blur.gaussian_kernel_1d(sigma))


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_blur_matches_jax_and_scipy(sigma):
    """σ 1.0 (the train slices) and 1.5 (the test volumes) on a (3, 40, 52)
    stack: each slice blurred in the plane, as the JAX function and scipy
    with σ 0 along the stack give it."""
    x = np.random.default_rng(0).standard_normal((3, 40, 52)).astype(np.float32)
    got = blur.gaussian_blur_2d(torch.from_numpy(x), sigma)
    assert got.dtype == torch.float32 and got.shape == x.shape
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(jax_blur.gaussian_blur_2d(jnp.asarray(x),
                                                                         sigma)), atol=1e-5)
    np.testing.assert_allclose(got, gaussian_filter(x, (0, sigma, sigma)), atol=1e-5)


def test_blur_radius_beyond_the_image():
    """A 5 x 7 image at σ 1.5: the radius (6) exceeds both sides, so the
    reflection repeats; scipy is the oracle (the JAX function agrees here)."""
    x = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
    want = gaussian_filter(x, 1.5)
    got = blur.gaussian_blur_2d(torch.from_numpy(x), 1.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jax_blur.gaussian_blur_2d(jnp.asarray(x), 1.5)),
                               want, atol=1e-5)
    np.testing.assert_allclose(blur.gaussian_blur_host(x, 1.5), want)


@pytest.mark.parametrize("n,r", [(5, 2), (5, 6), (1, 3), (4, 9)])
def test_reflect_index_is_numpy_symmetric(n, r):
    want = np.pad(np.arange(n), r, mode="symmetric")
    np.testing.assert_array_equal(blur.reflect_index(n, r).numpy(), want)
