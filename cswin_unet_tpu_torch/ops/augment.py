"""Training augmentation on the batch's device (``--device_augment``).

Counterpart of ``cswin_unet_tpu/ops/augment.py``: per sample, with the
reference's branch draws (``datasets/dataset_synapse.py:12-47``, as the host
``data.transforms.RandomGenerator`` draws them):

  * u1 > 0.5: rot90 by k in {0..3}, then a flip on axis in {0, 1};
  * otherwise u2 > 0.5: a rotation by an integer angle in [-20, 20) degrees
    about the center, nearest sampling, zero fill
    (``scipy.ndimage.rotate(order=0, reshape=False)``);
  * otherwise the sample as it is.

Every branch is an index map of the output pixels onto the input's, so the
whole batch is one gather of the image and one of the label, with the
per-sample branch chosen by ``torch.where``: no Python branch per sample and
no copy to the host. The draws come from an explicit ``torch.Generator`` on
the batch's device (the trainer's, which ``train_state.pt`` saves).
``jax.random``'s bits cannot be reproduced, so the ops are held to the JAX
functions at fixed draws and the branch shares by statistics.

Inputs are pre-resized square slices, as in the JAX package: resizing stays
on the host (``data.transforms.EvalResize``).
"""

from __future__ import annotations

import math

import torch

from ..parallel import rank_rows, world_size


def _grid(H: int, W: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Output row and column indices, each (1, H, W) int64."""
    i = torch.arange(H, device=device).view(1, H, 1).expand(1, H, W)
    j = torch.arange(W, device=device).view(1, 1, W).expand(1, H, W)
    return i, j


def _rot_flip_index(k: torch.Tensor, axis: torch.Tensor, H: int, W: int):
    """Source (row, col) of every output pixel of ``flip(rot90(x, k),
    axis)`` per sample (k, axis: (B,) int): ``jnp.rot90``'s direction
    (rot90(x)[i, j] = x[j, W-1-i]), then the flip."""
    if H != W:
        raise ValueError(f"rot90 keeps the shape of square slices only, got {H}x{W}")
    i, j = _grid(H, W, k.device)
    k, axis = k.view(-1, 1, 1), axis.view(-1, 1, 1)
    # The flip acts on the rotated image: read it at the flipped position.
    fi = torch.where(axis == 0, H - 1 - i, i)
    fj = torch.where(axis == 0, j, W - 1 - j)
    n = H - 1
    src_i = torch.where(k == 0, fi, torch.where(k == 1, fj, torch.where(k == 2, n - fi,
                                                                         n - fj)))
    src_j = torch.where(k == 0, fj, torch.where(k == 1, n - fi, torch.where(k == 2, n - fj,
                                                                             fi)))
    return src_i, src_j


def _rotate_index(angle: torch.Tensor, H: int, W: int):
    """Source (row, col) and validity of every output pixel of a rotation by
    ``angle`` degrees (B,) about ((H-1)/2, (W-1)/2): the inverse map in
    float32 as the JAX function computes it (θ = -angle·π/180; the cosine
    and sine are float32's nearest to the exact values, so the card and the
    host agree), rounded half to even."""
    dev = angle.device
    f32 = torch.float32
    theta = (-angle.to(f32)) * torch.tensor(math.pi, dtype=f32, device=dev) / 180.0
    cos = torch.cos(theta.double()).to(f32).view(-1, 1, 1)
    sin = torch.sin(theta.double()).to(f32).view(-1, 1, 1)
    cy = torch.tensor((H - 1) / 2.0, dtype=f32, device=dev)
    cx = torch.tensor((W - 1) / 2.0, dtype=f32, device=dev)
    yy = torch.arange(H, dtype=f32, device=dev).view(1, H, 1) - cy
    xx = torch.arange(W, dtype=f32, device=dev).view(1, 1, W) - cx
    src_y = cos * yy - sin * xx + cy
    src_x = sin * yy + cos * xx + cx
    iy = torch.round(src_y).to(torch.int64)
    ix = torch.round(src_x).to(torch.int64)
    valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    return iy.clamp(0, H - 1), ix.clamp(0, W - 1), valid


def _gather(img: torch.Tensor, lab: torch.Tensor, src_i: torch.Tensor,
            src_j: torch.Tensor, valid: torch.Tensor | None):
    """img (B, H, W), lab (B, H, W) read at per-sample (B, H, W) indices;
    zeros where ``valid`` is False."""
    B, H, W = img.shape
    base = torch.arange(B, device=img.device).view(B, 1, 1) * (H * W)
    flat = (base + src_i * W + src_j).reshape(-1)
    out_i = img.reshape(-1)[flat].view(B, H, W)
    out_l = lab.reshape(-1)[flat].view(B, H, W)
    if valid is not None:
        valid = valid.expand(B, H, W)
        out_i = torch.where(valid, out_i, torch.zeros((), dtype=img.dtype, device=img.device))
        out_l = torch.where(valid, out_l, torch.zeros((), dtype=lab.dtype, device=lab.device))
    return out_i, out_l


def _per_sample(v, img: torch.Tensor) -> torch.Tensor:
    """A number or (B,) tensor as a (B,) tensor on ``img``'s device."""
    t = torch.as_tensor(v, device=img.device)
    return t.reshape(1).expand(img.shape[0]) if t.dim() == 0 else t


def rot_flip(img: torch.Tensor, lab: torch.Tensor, k, axis):
    """rot90 by ``k`` (``jnp.rot90``'s direction), then a flip on ``axis``;
    img and lab (B, H, W) with H == W, k and axis ints or (B,) tensors."""
    _, H, W = img.shape
    index = _rot_flip_index(_per_sample(k, img), _per_sample(axis, img), H, W)
    return _gather(img, lab, *index, None)


def rotate_nearest(img: torch.Tensor, lab: torch.Tensor, angle):
    """Rotation by ``angle`` degrees (a number or (B,) tensor) about the
    center, nearest sampling, zero fill; img and lab (B, H, W)."""
    _, H, W = img.shape
    return _gather(img, lab, *_rotate_index(_per_sample(angle, img), H, W))


def draw(B: int, generator: torch.Generator | None, device: torch.device) -> dict:
    """The per-sample draws of ``augment_batch``, in its order: u1, u2
    uniform in [0, 1), k in 0..3, axis in 0..1, angle in [-20, 20). Under a
    data-parallel process group each is drawn for the global batch and
    sliced to this rank's B rows (``parallel.rank_rows``)."""
    kw = dict(generator=generator, device=device)
    G = world_size() * B
    d = dict(u1=torch.rand(G, **kw), u2=torch.rand(G, **kw),
             k=torch.randint(0, 4, (G,), **kw), axis=torch.randint(0, 2, (G,), **kw),
             angle=torch.randint(-20, 20, (G,), **kw))
    return {k: rank_rows(v, B) for k, v in d.items()}


def branches(d: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(rot / flip, rotate) masks (B,) of the draws ``d``: rot / flip where
    u1 > 0.5, else a rotation where u2 > 0.5, else the identity."""
    flip = d["u1"] > 0.5
    return flip, ~flip & (d["u2"] > 0.5)


def augment_batch(images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample augmentation of a batch on its device.

    images: (B, H, W) or (B, H, W, 1); labels: (B, H, W). Returns the same
    shapes and dtypes. The draws (``draw``) come from ``generator``, which
    must live on the batch's device.
    """
    return apply_draws(images, labels, draw(labels.shape[0], generator, labels.device))


def apply_draws(images: torch.Tensor, labels: torch.Tensor,
                d: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``augment_batch`` at given draws ``d`` (as ``draw`` returns them, on
    the batch's device): one gather of the images and one of the labels."""
    squeeze = images.dim() == 4
    imgs = images[..., 0] if squeeze else images
    B, H, W = imgs.shape
    rf_i, rf_j = _rot_flip_index(d["k"], d["axis"], H, W)
    ro_i, ro_j, ro_ok = _rotate_index(d["angle"], H, W)
    id_i, id_j = _grid(H, W, imgs.device)
    flip, rotate = (m.view(B, 1, 1) for m in branches(d))
    src_i = torch.where(flip, rf_i, torch.where(rotate, ro_i, id_i))
    src_j = torch.where(flip, rf_j, torch.where(rotate, ro_j, id_j))
    out_i, out_l = _gather(imgs, labels, src_i, src_j, ~rotate | ro_ok)
    return (out_i[..., None] if squeeze else out_i), out_l
