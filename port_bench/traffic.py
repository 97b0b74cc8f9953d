"""The general traffic generator: training batches and served volumes, made
from a seed by the parameters of a traffic file.

Both draw CT-like slices: up to ``organs`` ellipses (ellipsoids in a volume)
labelled 1..organs over background 0, each organ with its own intensity,
plus noise, in [0, 1]. The same seed and parameters give the same tensors on
the same kind of device; what a seed changes is the content and the order,
never the amount of work: a volume pool always holds the same depths, evenly
spread over [depth_min, depth_max], in the seed's order.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one use (``stream``) of the run's ``seed``."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, seed < 0,
             *map(ord, stream)]
    lo, hi = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & (2 ** 63 - 1)


def _organs(gen, n: int, organs: int, device, dims: int):
    """Per item: centres in [0.2, 0.8], radii in [0.05, 0.2] of each axis
    (a volume's depth radius in [0.1, 0.3]), intensities in [0.2, 0.9]."""
    centre = torch.rand((n, organs, dims), generator=gen, device=device) * 0.6 + 0.2
    radius = torch.rand((n, organs, dims), generator=gen, device=device) * 0.15 + 0.05
    if dims == 3:
        radius[..., 0] = radius[..., 0] * (4 / 3) + 1 / 30
    level = torch.rand((n, organs), generator=gen, device=device) * 0.7 + 0.2
    return centre, radius, level


def _paint(coords, centre, radius, level, gen, device):
    """Labels (int64) and intensities (float32) over ``coords`` (..., dims)
    in [0, 1]: later organs cover earlier ones."""
    label = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=device)
    for k in range(centre.shape[0]):
        inside = (((coords - centre[k]) / radius[k]) ** 2).sum(-1) < 1
        label = torch.where(inside, torch.full_like(label, k + 1), label)
    levels = torch.cat([torch.full((1,), 0.05, device=device), level])
    noise = torch.randn(label.shape, generator=gen, device=device) * 0.05
    image = (levels[label] + noise).clamp_(0.0, 1.0)
    return image, label


def train_batches(cfg: dict, traffic: dict, seed: int, device) -> list[tuple]:
    """``traffic["pool_batches"]`` distinct batches of ``traffic["batch"]``
    slices at the config's size: (image (B, H, W, 1) float32, label (B, H,
    W) int64), on ``device``."""
    B, S = traffic["batch"], cfg["img_size"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "train_batches"))
    axis = (torch.arange(S, device=device, dtype=torch.float32) + 0.5) / S
    grid = torch.stack(torch.meshgrid(axis, axis, indexing="ij"), -1)   # (S, S, 2)
    out = []
    for _ in range(traffic["pool_batches"]):
        centre, radius, level = _organs(gen, B, traffic["organs"], device, 2)
        imgs, labs = zip(*(_paint(grid, centre[b], radius[b], level[b], gen, device)
                           for b in range(B)))
        out.append((torch.stack(imgs)[..., None], torch.stack(labs)))
    return out


def volume_depths(traffic: dict, seed: int) -> list[int]:
    """The pool's depths: ``pool`` values evenly spread over [depth_min,
    depth_max] (ends included), in an order drawn from the seed."""
    depths = np.rint(np.linspace(traffic["depth_min"], traffic["depth_max"],
                                 traffic["pool"])).astype(int)
    order = np.random.default_rng(sub_seed(seed, "volume_order")).permutation(len(depths))
    return [int(d) for d in depths[order]]


def volume_pool(cfg: dict, traffic: dict, seed: int, device) -> list[np.ndarray]:
    """The served volumes, (D, H, W) float32 on the host at the config's
    size, drawn on ``device`` and copied back."""
    S = cfg["img_size"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "volume_pool"))
    axis = (torch.arange(S, device=device, dtype=torch.float32) + 0.5) / S
    out = []
    for depth in volume_depths(traffic, seed):
        centre, radius, level = _organs(gen, 1, traffic["organs"], device, 3)
        z = (torch.arange(depth, device=device, dtype=torch.float32) + 0.5) / depth
        grid = torch.stack(torch.meshgrid(z, axis, axis, indexing="ij"), -1)
        image, _ = _paint(grid, centre[0], radius[0], level[0], gen, device)
        out.append(image.cpu().numpy())
    return out
