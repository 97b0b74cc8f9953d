"""Synthetic Synapse-layout datasets for tests and the chip smoke run.

The port's copy of ``cswin_unet_tpu.data.synthetic``, draw for draw: small
CT-like volumes with blob organs in the on-disk layout the readers expect
(``.npz`` slices, ``.npy.h5`` volumes and list files). The same arguments
give the JAX package's files. ``h5py`` is imported only when a volume is
written, so ``num_volumes=0`` (train slices only, one blob volume cut into
slices) needs numpy alone.
"""

from __future__ import annotations

import os

import numpy as np


def _make_volume(rng: np.random.Generator, depth: int, size: int, num_classes: int):
    image = rng.normal(0.2, 0.1, (depth, size, size)).astype(np.float32)
    label = np.zeros((depth, size, size), dtype=np.int64)
    yy, xx = np.mgrid[0:size, 0:size]
    for cls in range(1, num_classes):
        cy, cx = rng.uniform(0.2, 0.8, 2) * size
        r = rng.uniform(0.06, 0.16) * size
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
        z0, z1 = sorted(rng.integers(0, depth, 2).tolist())
        for z in range(z0, min(z1 + 1, depth)):
            label[z][blob] = cls
            image[z][blob] += 0.3 + 0.1 * cls
    return image, label


def make_synthetic_dataset(
    root: str,
    *,
    num_train_slices: int = 24,
    num_volumes: int = 2,
    size: int = 64,
    depth: int = 6,
    num_classes: int = 4,
    seed: int = 0,
) -> dict:
    """Create train_npz/, test_vol_h5/ and lists/ under ``root``."""
    rng = np.random.default_rng(seed)
    train_dir = os.path.join(root, "train_npz")
    vol_dir = os.path.join(root, "test_vol_h5")
    list_dir = os.path.join(root, "lists")
    for d in (train_dir, vol_dir, list_dir):
        os.makedirs(d, exist_ok=True)

    train_names = []
    slices_per_vol = max(1, num_train_slices // max(1, num_volumes))
    i = 0
    while i < num_train_slices:
        image, label = _make_volume(rng, slices_per_vol, size, num_classes)
        case = f"case{len(train_names) // slices_per_vol:04d}"
        for z in range(min(slices_per_vol, num_train_slices - i)):
            name = f"{case}_slice{z:03d}"
            np.savez(os.path.join(train_dir, name + ".npz"), image=image[z],
                     label=label[z])
            train_names.append(name)
            i += 1

    vol_names = []
    for v in range(num_volumes):
        import h5py

        image, label = _make_volume(rng, depth, size, num_classes)
        name = f"case{v + 100:04d}"
        with h5py.File(os.path.join(vol_dir, name + ".npy.h5"), "w") as f:
            f.create_dataset("image", data=image)
            f.create_dataset("label", data=label)
        vol_names.append(name)

    with open(os.path.join(list_dir, "train.txt"), "w") as f:
        f.write("\n".join(train_names) + "\n")
    with open(os.path.join(list_dir, "test_vol.txt"), "w") as f:
        f.write("\n".join(vol_names) + "\n")

    return {
        "root": root,
        "train_dir": train_dir,
        "vol_dir": vol_dir,
        "list_dir": list_dir,
        "num_classes": num_classes,
        "train_names": train_names,
        "vol_names": vol_names,
    }
