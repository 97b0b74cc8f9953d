"""Dataset readers for the Synapse/KiTS23/LiTS17 slice+volume layout.

The port's copy of ``cswin_unet_tpu.data.datasets``: the train split is one
``<case>.npz`` per 2D slice with keys ``image`` + ``label`` (or
``segmentation``), names from ``<list_dir>/train.txt``; the test split is
one ``<case>.npy.h5`` volume per case (``image``/``label`` or
``images``/``segmentations``), names from ``<list_dir>/test_vol.txt``.
``h5py`` is imported only when a test volume is read, so training needs
numpy alone.
"""

from __future__ import annotations

import os

import numpy as np


class SynapseDataset:
    def __init__(self, base_dir: str, list_dir: str, split: str, transform=None):
        self.transform = transform
        self.split = split
        with open(os.path.join(list_dir, split + ".txt")) as f:
            self.sample_list = [l.strip() for l in f.readlines() if l.strip()]
        self.data_dir = base_dir

    def __len__(self) -> int:
        return len(self.sample_list)

    def case_name(self, idx: int) -> str:
        return self.sample_list[idx]

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None) -> dict:
        name = self.sample_list[idx]
        if self.split == "train":
            with np.load(os.path.join(self.data_dir, name + ".npz")) as data:
                image = data["image"]
                label = data["label"] if "label" in data else data["segmentation"]
        else:
            import h5py

            path = os.path.join(self.data_dir, f"{name}.npy.h5")
            with h5py.File(path, "r") as data:
                if "label" in data:
                    image, label = data["image"][:], data["label"][:]
                else:
                    image, label = data["images"][:], data["segmentations"][:]

        sample = {"image": image, "label": label, "case_name": name}
        if self.transform is not None:
            sample = self.transform(sample, rng if rng is not None else np.random.default_rng())
        return sample
