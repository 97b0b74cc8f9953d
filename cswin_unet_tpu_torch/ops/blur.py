"""Gaussian blur on the device, and the scipy path it is held to.

Counterpart of ``cswin_unet_tpu/ops/blur.py``. The reference's robustness
tooling blurs datasets offline with ``scipy.ndimage.gaussian_filter`` (σ 1.0
train slices, σ 1.5 test volumes). ``gaussian_blur_2d`` computes the same
function on the tensor's device: scipy's truncated, normalised kernel
(radius ``int(truncate·σ + 0.5)``) and its ``reflect`` boundary, as two 1-D
passes in float32.

scipy's ``reflect`` is numpy's ``symmetric``: the edge sample repeats
(``d c b a | a b c d | d c b a``), which torch's ``F.pad(..., "reflect")``
does not do, and the reflection goes on periodically where the radius
exceeds the image. So the pad is built by index (``reflect_index``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's normalised 1-D Gaussian, radius int(truncate·σ +
    0.5), as float32."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def reflect_index(n: int, r: int, device=None) -> torch.Tensor:
    """Indices of an axis of length ``n`` padded by ``r`` on each side with
    scipy's ``reflect`` (numpy's ``symmetric``) boundary: period 2n, the
    second half mirrored, for any r."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def gaussian_blur_2d(images: torch.Tensor, sigma: float,
                     truncate: float = 4.0) -> torch.Tensor:
    """Blur (..., H, W) along the last two axes in float32 (scipy's
    ``gaussian_filter`` on each slice, ``reflect`` boundary); returns float32
    of the input's shape, on its device."""
    k = torch.from_numpy(gaussian_kernel_1d(sigma, truncate)).to(images.device)
    r = (k.numel() - 1) // 2
    shape = images.shape
    H, W = shape[-2:]
    x = images.reshape(-1, 1, H, W).float()
    x = x[:, :, reflect_index(H, r, x.device)][..., reflect_index(W, r, x.device)]
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return x.reshape(shape)


def gaussian_blur_host(image: np.ndarray, sigma: float) -> np.ndarray:
    """The scipy path (offline tooling)."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(image, sigma=sigma)
