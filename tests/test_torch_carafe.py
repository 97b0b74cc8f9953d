"""Port's fused CARAFE (GEMM + CARAFE kernel wrappers, on the CPU through
their plain versions) and its plain compositions against the JAX Pallas
CARAFE kernel (interpret mode) and the JAX compositions.

Tolerances: float32 rtol = atol = 1e-4 (different summation orders);
bf16 relative L2 error <= 0.02 (the reference gate's default); labels by
the margin rule of bench.py: a mismatch counts only where the reference's
top-2 logit gap exceeds 0.02·max|logit| (random weights give near-ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.ops.carafe import carafe as jax_carafe
from cswin_unet_tpu.ops.carafe import carafe_with_classifier as jax_cwc
from cswin_unet_tpu.ops.pallas.carafe_tail import carafe_fused_pallas
from cswin_unet_tpu_torch.ops.carafe import extract_patches_3x3
from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT
from cswin_unet_tpu_torch.ops.cuda.carafe_tail import (carafe_tail,
                                                       carafe_tail_argmax,
                                                       carafe_tail_argmax_plain,
                                                       carafe_tail_plain,
                                                       carafe_up,
                                                       carafe_up_plain)

torch.set_num_threads(2)


def _params(rng, C, C_out, up, nc=None):
    cm = C // 4
    mk = lambda *s, sc=0.2: (rng.standard_normal(s) * sc).astype(np.float32)
    p = dict(down_kernel=mk(1, 1, C, cm), down_bias=mk(cm),
             encoder_kernel=mk(3, 3, cm, 9 * up * up), encoder_bias=mk(9 * up * up),
             out_kernel=mk(1, 1, C, C_out), out_bias=mk(C_out))
    if nc is not None:
        p["cls_kernel"] = mk(1, 1, C_out, nc)
    return p


def _torch(p):
    """JAX HWIO conv kernels -> torch OIHW tensors, in argument order."""
    order = ("down_kernel", "down_bias", "encoder_kernel", "encoder_bias",
             "out_kernel", "out_bias", "cls_kernel")
    out = []
    for k in order:
        if k in p:
            a = p[k].transpose(3, 2, 0, 1) if p[k].ndim == 4 else p[k]
            out.append(torch.from_numpy(np.ascontiguousarray(a)))
    return out


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _margin_mismatches(labels, ref_logits):
    srt = np.sort(ref_logits, -1)
    margin = srt[..., -1] - srt[..., -2]
    thr = 0.02 * float(np.abs(ref_logits).max())
    mism = labels != ref_logits.argmax(-1)
    return int(np.sum(mism & (margin > thr)))


def test_extract_patches_matches_jax():
    from cswin_unet_tpu.ops.carafe import extract_patches_3x3 as jax_patches

    x = np.random.default_rng(0).standard_normal((2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(extract_patches_3x3(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_patches(jnp.asarray(x))))


@pytest.mark.parametrize("H,W", [(8, 8), (12, 10)])
def test_carafe_up_f32(H, W):
    rng = np.random.default_rng(0)
    p = _params(rng, C=16, C_out=8, up=2)
    x = rng.standard_normal((2, H, W, 16)).astype(np.float32)
    got = carafe_up(torch.from_numpy(x), *_torch(p), up_factor=2).numpy()
    plain = carafe_up_plain(torch.from_numpy(x), *_torch(p), up_factor=2).numpy()
    assert got.shape == (2, 2 * H, 2 * W, 8)
    pallas = np.asarray(carafe_fused_pallas(jnp.asarray(x), **_jax(p), up_factor=2))
    comp = np.asarray(jax_carafe(jnp.asarray(x), **_jax(p), kernel_size=3,
                                 up_factor=2))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(plain, comp, rtol=1e-4, atol=1e-4)


def test_carafe_up_bf16():
    rng = np.random.default_rng(1)
    p = _params(rng, C=32, C_out=16, up=2)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    tx = torch.from_numpy(x).bfloat16()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = carafe_up(tx, *_torch(p), up_factor=2)
    plain = carafe_up_plain(tx, *_torch(p), up_factor=2)
    assert got.dtype == plain.dtype == torch.bfloat16
    pallas = np.asarray(carafe_fused_pallas(xb, **_jax(p), up_factor=2), np.float32)
    comp = np.asarray(jax_carafe(xb, **_jax(p), kernel_size=3, up_factor=2),
                      np.float32)
    assert _rel_l2(got.float().numpy(), pallas) <= 0.02
    assert _rel_l2(plain.float().numpy(), comp) <= 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_logits_and_labels(dtype):
    rng = np.random.default_rng(2)
    p = _params(rng, C=16, C_out=16, up=4, nc=5)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    tp = _torch(p)

    logits = carafe_tail(tx, *tp, up_factor=4)
    plain = carafe_tail_plain(tx, *tp, up_factor=4)
    labels = carafe_tail_argmax(tx, *tp, up_factor=4)
    plain_labels = carafe_tail_argmax_plain(tx, *tp, up_factor=4)
    assert logits.shape == (2, 32, 32, 5) and labels.shape == (2, 32, 32)
    assert labels.dtype == plain_labels.dtype == torch.int32

    pallas = np.asarray(carafe_fused_pallas(jx, **_jax(p), up_factor=4), np.float32)
    comp = np.asarray(jax_cwc(jx, **_jax(p), kernel_size=3, up_factor=4), np.float32)
    pallas_labels = np.asarray(carafe_fused_pallas(jx, **_jax(p), up_factor=4,
                                                   emit="argmax"))
    got, pl = logits.float().numpy(), plain.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(pl, comp, rtol=1e-4, atol=1e-4)
    else:
        assert _rel_l2(got, pallas) <= 0.02
        assert _rel_l2(pl, comp) <= 0.02
    assert _margin_mismatches(labels.numpy(), pallas) == 0
    assert _margin_mismatches(plain_labels.numpy(), comp) == 0
    assert _margin_mismatches(pallas_labels, comp) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", ["up", "up-odd", "tail", "tail-argmax"])
def test_gy_channel_padding_leaves_outputs_bit_equal(site, dtype, monkeypatch):
    """The (down | classes) GEMM's output channels padded to a multiple of 8
    (``gy_channels``: the tail's 4 + 5 -> 16, up's 8 + 16 -> 24 stays, 10
    + 12 -> 24) give the same bits as the unpadded plain path."""
    fn, C, C_out, up, nc, H, W = {
        "up": (carafe_up, 32, 16, 2, None, 8, 8),
        "up-odd": (carafe_up, 40, 12, 2, None, 7, 5),
        "tail": (carafe_tail, 16, 16, 4, 5, 8, 8),
        "tail-argmax": (carafe_tail_argmax, 16, 16, 4, 5, 6, 9)}[site]
    rng = np.random.default_rng(5)
    tp = _torch(_params(rng, C=C, C_out=C_out, up=up, nc=nc))
    x = torch.from_numpy(rng.standard_normal((2, H, W, C)).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    assert CT.gy_channels(C // 4, nc or C_out) % 8 == 0
    padded = fn(x, *tp, up_factor=up)
    monkeypatch.setattr(CT, "gy_channels", lambda c_mid, n: c_mid + n)
    tight = fn(x, *tp, up_factor=up)
    assert padded.dtype == tight.dtype and torch.equal(padded, tight)
