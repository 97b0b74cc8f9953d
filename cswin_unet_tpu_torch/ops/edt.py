"""Euclidean distance transform and the Dice / HD95 volume metrics on the
device.

Counterpart of ``cswin_unet_tpu.ops.edt``, the device twin of ``metrics``:
boundary voxels are ``mask ^ binary_erosion(mask)`` with the cross
structuring element and a zero border (scipy semantics); HD95 is the 95th
``np.percentile`` (linear interpolation) of the CONCATENATED directed
surface distances; the edge rules are ``calculate_metric_percase``'s
(pred>0 & gt==0 -> (1, 0); pred empty -> (0, 0)).

The exact squared EDT is three 1-D min-plus passes ``g[i] = min_j (i-j)² +
f[j]``, one per axis, each through the CUDA kernel ``ops.cuda.kernels
.edt_pass`` on a CUDA tensor (its plain version on a CPU tensor). Every
function here runs on the device of its inputs; ``volume_metrics_device``
returns one (C-1, 2) tensor there, the only thing the caller copies back.
"""

from __future__ import annotations

import math

import torch

from .cuda.kernels import edt_pass

_INF = 1e12  # "no seed", as float32 (the JAX package's _INF)


def edt_sq(seeds: torch.Tensor) -> torch.Tensor:
    """Exact SQUARED euclidean distance to the nearest True seed, float32.

    seeds: bool, any rank >= 1; passes run over every axis of size > 1.
    Matches ``scipy.ndimage.distance_transform_edt(~seeds)**2`` (spacing 1).
    Voxels with no seed anywhere come back ~1e12.
    """
    f = torch.full(seeds.shape, _INF, dtype=torch.float32, device=seeds.device)
    f.masked_fill_(seeds, 0.0)
    for ax in range(f.dim() - 1, -1, -1):
        if f.shape[ax] > 1:
            f = edt_pass(f, ax)
    return f


def boundary(mask: torch.Tensor) -> torch.Tensor:
    """mask ^ binary_erosion(mask) with the cross element and out-of-volume
    == False (scipy ``binary_erosion`` border_value=0): a True voxel is a
    boundary voxel iff any face neighbour (outside the volume included) is
    False. A single-voxel-thick axis erodes everything, as in scipy."""
    m = mask.bool()
    er = m.clone()
    for ax, n in enumerate(m.shape):
        if n == 1:
            er.zero_()
            continue
        lo = torch.zeros_like(m)  # lo[i] = m[i - 1], False at i = 0
        hi = torch.zeros_like(m)  # hi[i] = m[i + 1], False at i = n - 1
        lo.narrow(ax, 1, n - 1).copy_(m.narrow(ax, 0, n - 1))
        hi.narrow(ax, 0, n - 1).copy_(m.narrow(ax, 1, n - 1))
        er &= lo & hi
    return m & ~er


def _percentile95(values: torch.Tensor) -> torch.Tensor:
    """``np.percentile(values, 95)`` with linear interpolation, the position
    and the interpolation in float64; 0 for an empty input (the edge rules
    then select 0 anyway)."""
    m = values.numel()
    if m == 0:
        return torch.zeros((), dtype=torch.float64, device=values.device)
    x = torch.sort(values.double()).values
    pos = 0.95 * (m - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, m - 1)
    frac = pos - lo
    return x[lo] * (1.0 - frac) + x[hi] * frac


def hd95_pair(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """HD95 between two binary volumes (medpy convention), float64 scalar
    on their device. The boundary distances are gathered (a sync for their
    count, not their values) before the percentile."""
    pb = boundary(pred)
    gb = boundary(gt)
    d_gt = edt_sq(gb).clamp_min_(0.0).sqrt_()
    d_pr = edt_sq(pb).clamp_min_(0.0).sqrt_()
    return _percentile95(torch.cat([d_gt[pb], d_pr[gb]]))


def dice_pair(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Binary Dice from exact voxel counts, float64; 0 when both masks are
    empty (metrics.dice_binary)."""
    p, g = pred.bool(), gt.bool()
    inter = (p & g).sum()
    denom = p.sum() + g.sum()
    return torch.where(denom == 0, 0.0, 2.0 * inter.double() / denom.clamp_min(1))


def zoom_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``scipy.ndimage.zoom(order=0, grid_mode=False)`` over the LAST TWO
    axes: in_idx = floor(i · (in-1)/(out-1) + 0.5), with the map computed in
    float32 as the JAX package does (exact against scipy on integer masks:
    tests/test_torch_edt.py)."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = out_hw

    def idx(n_out, n_in):
        if n_out == 1 or n_in == 1:
            return torch.zeros(n_out, dtype=torch.long, device=x.device)
        i = torch.arange(n_out, dtype=torch.float32, device=x.device)
        return torch.floor(i * ((n_in - 1) / (n_out - 1)) + 0.5).long().clamp_(0, n_in - 1)

    x = x.index_select(-2, idx(h_out, h_in))
    return x.index_select(-1, idx(w_out, w_in))


def volume_metrics_device(prediction: torch.Tensor, label: torch.Tensor,
                          num_classes: int) -> torch.Tensor:
    """Per-class (dice, hd95) for classes 1..C-1 on the inputs' device.

    prediction / label: (D, H, W) integer tensors on one device. Returns a
    (C-1, 2) float64 tensor there, with the calculate_metric_percase edge
    rules. HD95 runs for every class, empty or not, as in the JAX package
    (the edge rules select the output), so a volume costs the same EDT
    launches whatever its labels: 2 EDTs x (axes of size > 1) per class.
    """
    outs = []
    for c in range(1, num_classes):
        pred = prediction == c
        gt = label == c
        has_p, has_g = pred.any(), gt.any()
        both = has_p & has_g
        dice = torch.where(both, dice_pair(pred, gt), torch.where(has_p, 1.0, 0.0)
                           .double())
        hd = torch.where(both, hd95_pair(pred, gt), 0.0)
        outs.append(torch.stack([dice, hd]))
    return torch.stack(outs)
