"""The block backward's two redesigned kernels, in what the CPU can check.

* ``stripe_attention_bwd_plain`` (the function the CUDA kernel is held to
  on the card) against ``jax.vjp`` of the JAX package's
  ``cswin_attention_xla`` at base-384's 288-token windows (24x12 and 12x24,
  head dim 24), float32, rtol = atol = 1e-4 (the frameworks sum in
  different orders, on O(1) values).
* The launch planners in Python: ``wgrad_plan`` (how the weight gradient
  cuts M into one wave of CTAs, and the partial bytes it writes) and
  ``stripe_attention_bwd_smem`` (the attention backward's shared memory,
  mirrored from the kernel source and checked against it on the card by
  ``tests/test_torch_cuda.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.ops.attention import cswin_attention_xla as jax_attention
from cswin_unet_tpu_torch import config as port_config
from cswin_unet_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_BATCH = 24


@pytest.mark.parametrize("branch", [0, 1])
def test_plain_attention_bwd_matches_jax_vjp_at_base384_windows(branch):
    B, H, W, cb, heads = 1, 24, 24, 48, 2          # head dim 24, as base-384
    C = 2 * cb
    h_sp, w_sp = ((H, 12), (12, W))[branch]         # 24x12 and 12x24: L = 288
    off = branch * cb
    scale = (cb // heads) ** -0.5
    rng = np.random.default_rng(30 + branch)
    qkv = rng.standard_normal((B, H, W, 3 * C)).astype(np.float32)
    dout = rng.standard_normal((B, H, W, C)).astype(np.float32)
    lk = (rng.standard_normal((3, 3, 1, cb)) * 0.3).astype(np.float32)  # HWIO
    lb = (rng.standard_normal(cb) * 0.1).astype(np.float32)
    q, k, v = (qkv[..., i * C + off:i * C + off + cb] for i in range(3))

    def branch_fn(q_, k_, v_, lk_, lb_):
        return jax_attention(q_, k_, v_, lk_, lb_, h_sp=h_sp, w_sp=w_sp,
                             num_heads=heads, scale=scale)

    _, vjp = jax.vjp(branch_fn, *map(jnp.asarray, (q, k, v, lk, lb)))
    dq, dk, dv, dlk, dlb = (np.asarray(g) for g in vjp(jnp.asarray(dout[..., off:off + cb])))

    dqkv = torch.zeros(B, H, W, 3 * C)
    lw = torch.from_numpy(np.ascontiguousarray(lk.transpose(3, 2, 0, 1)))
    dw, db = K.stripe_attention_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(dout), lw, dqkv, ch_off=off,
        heads=heads, h_sp=h_sp, w_sp=w_sp, scale=scale)
    for i, want in enumerate((dq, dk, dv)):
        got = dqkv[..., i * C + off:i * C + off + cb].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), dlk.transpose(3, 2, 0, 1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), dlb, rtol=1e-4, atol=1e-4)
    # the other branch's channels are left alone
    rest = torch.ones(3 * C, dtype=torch.bool)
    for i in range(3):
        rest[i * C + off:i * C + off + cb] = False
    assert not dqkv[..., rest].any()


def _geometries(yaml: str):
    """(H, C, heads, split, last) of each stage of a config."""
    import argparse

    args = argparse.Namespace(cfg=os.path.join(REPO, "cswin_unet_tpu_torch", "configs", yaml),
                              opts=None)
    cfg = port_config.get_config(args)
    cs, img = cfg.MODEL.CSWIN, cfg.DATA.IMG_SIZE
    for s in range(4):
        H = img // (4 * 2**s)
        yield H, cs.EMBED_DIM * 2**s, cs.NUM_HEADS[s], cs.SPLIT_SIZE[s], \
            s == 3 or H == cs.SPLIT_SIZE[s]


def _wgrad_shapes(min_reso: int = 0):
    """(M, N, K) of the four weight gradients of each dual-branch stage of
    tiny-224 at the training batch (stages 1-3; the trainer routes those at
    resolution >= 28 through the kernels)."""
    for H, C, _, _, last in _geometries("cswin_tiny_224_lite.yaml"):
        if not last and H >= min_reso:
            M = TRAIN_BATCH * H * H
            yield from ((M, C, 4 * C), (M, 4 * C, C), (M, C, C), (M, 3 * C, C))


@pytest.mark.parametrize("M,N,K_", [*_wgrad_shapes(), (1001, 96, 64), (64, 512, 2048),
                                    (130, 24, 64), (7, 8, 8), (75264, 2048, 2048),
                                    (4099, 40, 136)])
def test_wgrad_plan_covers_m_in_one_wave(M, N, K_):
    p = K.wgrad_plan(M, N, K_)
    # 128-wide tiles where they divide N or K, so fewer tiles re-read the
    # narrow operand
    assert (p.bn, p.bk) == (128 if N % 128 == 0 else 64, 128 if K_ % 128 == 0 else 64)
    assert p.tiles == -(-N // p.bn) * -(-K_ // p.bk)
    assert p.cluster in (1, 2, 4, 8) and p.splits % p.cluster == 0
    assert p.chunk % 64 == 0 and p.chunk > 0
    # the splits' row ranges cover [0, M) exactly, in order, and the last
    # cluster holds at least one non-empty split
    ranges = [(min(M, s * p.chunk), min(M, (s + 1) * p.chunk)) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert (p.splits - p.cluster) * p.chunk < M
    # one wave when the tiles leave room for splits; else one split a tile
    assert p.splits * p.tiles <= max(132, p.tiles)
    clusters = p.splits // p.cluster
    want = (4 * clusters * p.bn * (p.tiles * p.bk + -(-N // p.bn))) if clusters > 1 else 0
    assert p.partial_bytes == want
    assert 8 * p.partial_bytes <= 2 * M * (N + K_)


@pytest.mark.parametrize("M,N,K_", list(_wgrad_shapes()))
def test_wgrad_partials_stay_under_a_quarter_of_the_operands(M, N, K_):
    p = K.wgrad_plan(M, N, K_)
    assert p.partial_bytes <= 0.25 * 2 * M * (N + K_)


@pytest.mark.parametrize("M,N,K_", list(_wgrad_shapes(min_reso=28)))
def test_wgrad_wave_fills_the_card_at_the_trained_stages(M, N, K_):
    p = K.wgrad_plan(M, N, K_)
    assert 0.75 * 132 <= p.splits * p.tiles <= 132
    # where only 14 clusters of 8 fit at once (the occupancy API's answer
    # on a card whose smaller GPCs hold one), the wave shrinks to fit
    fit = lambda bn, bk, cl: {8: 14, 4: 30, 2: 64, 1: 132}[cl]
    q = K.wgrad_plan(M, N, K_, fit)
    assert q.splits * q.tiles <= fit(q.bn, q.bk, q.cluster) * q.cluster


def _attention_windows():
    """(yaml, L, d) of every stripe branch (and last-stage window) of
    tiny-224 and base-384."""
    for yaml in ("cswin_tiny_224_lite.yaml", "cswin_base_384.yaml"):
        for H, C, heads, split, last in _geometries(yaml):
            d = C // heads
            for hs, ws in ([(H, H)] if last else [(H, split), (split, H)]):
                yield yaml, hs * ws, d


@pytest.mark.parametrize("yaml,L,d", sorted(set(_attention_windows())))
def test_attention_bwd_smem_fits_every_geometry(yaml, L, d):
    assert K.stripe_attention_bwd_smem(L, d) <= K.SMEM_LIMIT


@pytest.mark.parametrize("d", [24, 32])
def test_attention_bwd_smem_takes_base384_windows(d):
    assert (24 * 12, 24) in {(L, dd) for _, L, dd in _attention_windows()}
    assert K.stripe_attention_bwd_smem(288, d) <= K.SMEM_LIMIT
    # its parts: four staged bf16 tiles, two key-block tiles, four warps'
    # two 16-row output tiles, the taps, and beyond one key block the row
    # statistics and dQ accumulators
    lp, stride = 288, 40
    fixed = 4 * 2 * 16 * stride * 2 + 9 * d * 4
    assert K.stripe_attention_bwd_smem(288, d) == (
        4 * lp * stride * 2 + 2 * lp * 72 * 2 + fixed + lp * (3 + d) * 4)
    # one key block holds no statistics; past the limit the wrapper refuses
    assert K.stripe_attention_bwd_smem(64, d) == 4 * 64 * stride * 2 + 2 * 64 * 72 * 2 + fixed
    assert K.stripe_attention_bwd_smem(304, 32) > K.SMEM_LIMIT
