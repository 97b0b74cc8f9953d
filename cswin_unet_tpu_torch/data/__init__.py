"""Data pipeline: Synapse-layout readers, augmentations, loader."""

from .datasets import SynapseDataset
from .loader import DataLoader, device_prefetch
from .transforms import EvalResize, RandomGenerator

__all__ = ["DataLoader", "EvalResize", "RandomGenerator", "SynapseDataset",
           "device_prefetch"]
