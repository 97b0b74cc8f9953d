"""Training augmentations — host-side numpy/scipy, parity-exact.

The port's copy of ``cswin_unet_tpu.data.transforms`` (numpy and scipy
only; that package's ``data/__init__`` imports JAX). Same rng draws in the
same order, so the same seed gives the JAX loader's batches.

Reproduces the reference ``RandomGenerator`` pipeline
(``datasets/dataset_synapse.py:12-47``) including its branch probabilities
(P(rot90+flip)=0.5, else P(rotate ±20°)=0.5 → net 0.25), scipy interpolation
orders (rotate order=0; zoom order=3 for images, order=0 for labels — the
order-0 label handling is correctness-critical for DSC parity), and dtype
conventions (image float32 with a trailing channel axis, label int).

Randomness is drawn from an explicit ``np.random.Generator`` (the reference
uses module-global ``random``/``np.random`` state; an explicit generator
makes multi-worker loading deterministic).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def random_rot_flip(image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    k = int(rng.integers(0, 4))
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = int(rng.integers(0, 2))
    image = np.flip(image, axis=axis).copy()
    label = np.flip(label, axis=axis).copy()
    return image, label


def random_rotate(image: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    angle = int(rng.integers(-20, 20))
    image = ndimage.rotate(image, angle, order=0, reshape=False)
    label = ndimage.rotate(label, angle, order=0, reshape=False)
    return image, label


def zoom_to(image: np.ndarray, size: tuple[int, int], order: int) -> np.ndarray:
    x, y = image.shape
    if (x, y) == tuple(size):
        return image
    return ndimage.zoom(image, (size[0] / x, size[1] / y), order=order)


class RandomGenerator:
    """Augment + resize one (image, label) sample to ``output_size``.

    Returns image (H, W, 1) float32 NHWC and label (H, W) int32.
    """

    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image, label = sample["image"], sample["label"]

        if rng.random() > 0.5:
            image, label = random_rot_flip(image, label, rng)
        elif rng.random() > 0.5:
            image, label = random_rotate(image, label, rng)

        image = zoom_to(image, self.output_size, order=3)
        label = zoom_to(label, self.output_size, order=0)

        out = dict(sample)
        out["image"] = image.astype(np.float32)[..., None]
        out["label"] = label.astype(np.int32)
        return out


class EvalResize:
    """Deterministic resize for eval-time slices (no augmentation)."""

    def __init__(self, output_size):
        self.output_size = tuple(output_size)

    def __call__(self, sample: dict, rng=None) -> dict:
        out = dict(sample)
        out["image"] = zoom_to(sample["image"], self.output_size, order=3).astype(
            np.float32
        )[..., None]
        out["label"] = zoom_to(sample["label"], self.output_size, order=0).astype(
            np.int32
        )
        return out
