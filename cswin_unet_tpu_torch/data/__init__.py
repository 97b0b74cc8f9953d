"""Data pipeline: Synapse-layout readers, augmentations, loader."""

from .datasets import Subset, SynapseDataset
from .loader import DataLoader, device_prefetch
from .synthetic import make_synthetic_dataset
from .transforms import EvalResize, RandomGenerator

__all__ = ["DataLoader", "EvalResize", "RandomGenerator", "Subset", "SynapseDataset",
           "device_prefetch", "make_synthetic_dataset"]
