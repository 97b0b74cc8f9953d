"""The port's device augmentation (``ops/augment.py``) against the JAX
package's (``cswin_unet_tpu/ops/augment.py``) and scipy.

``jax.random``'s bits cannot be reproduced in torch, so each op is held to
the JAX function at fixed draws, bit for bit (``rot_flip`` at every k and
axis, ``rotate_nearest`` at every integer angle the draws can give; a
difference is allowed only at a rounding tie, |src - round(src)| within 1e-4
of 0.5), and the branch shares (0.5 rot / flip, 0.25 rotate, 0.25 identity)
by statistics over 4000 draws, each within 4 standard deviations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cswin_unet_tpu.ops.augment import _rot_flip, _rotate_nearest
from cswin_unet_tpu_torch.ops import augment as A

torch.set_num_threads(2)


def _sample(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.integers(0, 9, (n, n)).astype(np.int32))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_rot_flip_matches_jax(k, axis):
    img, lab = _sample(24)
    want_i, want_l = _rot_flip(jnp.asarray(img), jnp.asarray(lab), jnp.int32(k),
                               jnp.int32(axis))
    got_i, got_l = A.rot_flip(torch.from_numpy(img)[None], torch.from_numpy(lab)[None],
                              k, axis)
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l[0].numpy(), np.asarray(want_l))
    # and numpy's rot90 / flip, as the host transform applies them
    np.testing.assert_array_equal(got_i[0].numpy(), np.flip(np.rot90(img, k), axis))


def _ties(n: int, angle: int) -> np.ndarray:
    """Output pixels whose source coordinate sits at a rounding tie."""
    th = -angle * np.pi / 180.0
    c = (n - 1) / 2.0
    yy, xx = np.mgrid[0:n, 0:n] - c
    src = np.stack([np.cos(th) * yy - np.sin(th) * xx, np.sin(th) * yy + np.cos(th) * xx]) + c
    frac = np.abs(src - np.floor(src))
    return np.any(np.abs(frac - 0.5) <= 1e-4, axis=0)


@pytest.mark.parametrize("n,ties", [(32, 0), (33, 0), (384, 4)])
def test_rotate_nearest_matches_jax_at_every_angle(n, ties):
    """All 40 integer angles in [-20, 20), one (B, n, n) batch per angle
    set; the port's batch gather against JAX's per-sample function. The
    port takes float32's nearest cosine and sine (so that the card and the
    host agree); XLA's float32 sine of 13° is one ulp off it, which moves
    two rounding ties at ±13° at n = 384 (src 57.499985): ``ties`` counts
    the pixels that differ, all of them ties."""
    img, lab = _sample(n, seed=n)
    angles = np.arange(-20, 20)
    imgs = torch.from_numpy(np.broadcast_to(img, (40, n, n)).copy())
    labs = torch.from_numpy(np.broadcast_to(lab, (40, n, n)).copy())
    got_i, got_l = A.rotate_nearest(imgs, labs, torch.from_numpy(angles))
    differ = 0
    for b, angle in enumerate(angles):
        want_i, want_l = _rotate_nearest(jnp.asarray(img), jnp.asarray(lab),
                                         jnp.float32(angle))
        bad = (got_i[b].numpy() != np.asarray(want_i)) | (got_l[b].numpy()
                                                           != np.asarray(want_l))
        assert not np.any(bad & ~_ties(n, int(angle))), angle
        differ += int(bad.sum())
    assert differ == ties


def test_rotate_nearest_agrees_with_scipy():
    """scipy.ndimage.rotate(order=0, reshape=False): near-total agreement
    (its resampling may break boundary ties otherwise), as the JAX
    package's own test requires."""
    img, lab = _sample(32, seed=1)
    for angle in (-19, -7, 5, 13):
        got_i, got_l = A.rotate_nearest(torch.from_numpy(img)[None],
                                        torch.from_numpy(lab)[None], angle)
        assert np.mean(got_i[0].numpy() == ndimage.rotate(img, angle, order=0,
                                                          reshape=False)) > 0.95
        assert np.mean(got_l[0].numpy() == ndimage.rotate(lab, angle, order=0,
                                                          reshape=False)) > 0.95


def test_branch_shares():
    """4000 draws: rot / flip 0.5, rotate 0.25, identity 0.25, each within
    4 standard deviations; k, axis and angle over their whole ranges."""
    n = 4000
    d = A.draw(n, torch.Generator().manual_seed(0), torch.device("cpu"))
    flip, rotate = A.branches(d)
    for share, p in ((flip, 0.5), (rotate, 0.25), (~flip & ~rotate, 0.25)):
        got = float(share.float().mean())
        assert abs(got - p) <= 4 * np.sqrt(p * (1 - p) / n), (got, p)
    assert set(d["k"].tolist()) == {0, 1, 2, 3} and set(d["axis"].tolist()) == {0, 1}
    assert set(d["angle"].tolist()) == set(range(-20, 20))


@pytest.mark.parametrize("rank", [3, 4])
def test_augment_batch_applies_its_draws(rank):
    """Each sample of ``augment_batch`` is the op its draws pick, at those
    draws (the same seed replays them); shapes and dtypes kept for
    (B, H, W) and (B, H, W, 1) images."""
    rng = np.random.default_rng(2)
    B, n = 64, 20
    imgs = torch.from_numpy(rng.standard_normal((B, n, n)).astype(np.float32))
    labs = torch.from_numpy(rng.integers(0, 5, (B, n, n)).astype(np.int64))
    x = imgs[..., None] if rank == 4 else imgs
    out_i, out_l = A.augment_batch(x, labs, torch.Generator().manual_seed(5))
    assert out_i.shape == x.shape and out_i.dtype == x.dtype
    assert out_l.shape == labs.shape and out_l.dtype == labs.dtype
    out_i = out_i[..., 0] if rank == 4 else out_i
    d = A.draw(B, torch.Generator().manual_seed(5), torch.device("cpu"))
    flip, rotate = A.branches(d)
    assert 0 < int(flip.sum()) < B and 0 < int(rotate.sum()) < B
    rf = A.rot_flip(imgs, labs, d["k"], d["axis"])
    ro = A.rotate_nearest(imgs, labs, d["angle"])
    for b in range(B):
        want = rf if flip[b] else ro if rotate[b] else (imgs, labs)
        assert torch.equal(out_i[b], want[0][b]) and torch.equal(out_l[b], want[1][b]), b


def test_augment_batch_same_seed_same_output():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.standard_normal((8, 16, 16, 1)).astype(np.float32))
    labs = torch.from_numpy(rng.integers(0, 3, (8, 16, 16)).astype(np.int32))
    a = A.augment_batch(imgs, labs, torch.Generator().manual_seed(7))
    b = A.augment_batch(imgs, labs, torch.Generator().manual_seed(7))
    c = A.augment_batch(imgs, labs, torch.Generator().manual_seed(8))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert set(torch.unique(a[1]).tolist()) <= {0, 1, 2}


def test_rot_flip_refuses_non_square():
    with pytest.raises(ValueError, match="square"):
        A.rot_flip(torch.zeros(1, 4, 6), torch.zeros(1, 4, 6), 1, 0)
