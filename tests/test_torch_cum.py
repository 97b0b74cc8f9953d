"""The one-block kernel's build-up levels (``block_one`` with a ``level``,
its plain version on the CPU) against the levels of ``scripts/exp_cum.py``.

The script is not imported (at import it sets a compilation-cache directory
and imports ``exp_hb``): each level is composed here from the same calls its
``make_level_kernel.kern`` makes (``cb._layernorm``, ``cb._dot``,
``cb._attn_auto``, ``cb._lepe_windows(swap=True)``, ``cb._branch_horizontal``,
``cb._erf``), with the same inputs (x and its transpose) and the qkv weight
split into the two halves' columns as ``main`` splits it, inside
``pl.pallas_call(interpret=True)``, one image per grid step. The script's
timing chain adds ``1e-6·x`` outside the kernel; that is not part of a level.

Tolerance: bf16 relative L2 <= 0.02 (the reference gate's default), at
8x8, C 64, heads 2, split 2, B 2, weights at scale 0.3. Each level also
moves the output by more than that limit against the level before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cswin_unet_tpu.ops.pallas.cswin_block as cb
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.ops.cuda.cswin_block import BlockParams

torch.set_num_threads(2)

TOL = 0.02
H = W = 8
C, HEADS, SPLIT, B = 64, 2, 2, 2
SCALE = 32 ** -0.5  # exp_cum.py's scale


def _fold(y, c):
    k = y.shape[-1] // c
    return sum(y[:, i * c:(i + 1) * c] for i in range(k))


def _level_kernel(level):
    """``exp_cum.py::make_level_kernel`` at this geometry."""
    half, h2, nW = C // 2, HEADS // 2, W // SPLIT

    def kern(x_ref, xt_ref, n1s, n1b, wqkv_h, bqkv_h, wqkv_v, bqkv_v, lk0, lb0, lk1, lb1,
             projk, projb, n2s, n2b, fc1k, fc1b, fc2k, fc2b, o_ref):
        x = x_ref[...].reshape(H * W, C)
        xt = xt_ref[...].reshape(W * H, C)
        acc = x.astype(jnp.float32) + xt.astype(jnp.float32) * 1e-6
        if level >= 1:
            xn = cb._layernorm(x, n1s[...], n1b[...])
            qkv_h = cb._dot(xn, wqkv_h[...], bqkv_h[...])
            acc += jnp.concatenate([_fold(qkv_h, half)] * 2, -1).astype(jnp.float32)
        if level >= 2:
            xtn = cb._layernorm(xt, n1s[...], n1b[...])
            qkv_v = cb._dot(xtn, wqkv_v[...], bqkv_v[...])
            acc += jnp.concatenate([_fold(qkv_v, half)] * 2, -1).astype(jnp.float32)
        if level >= 3:
            qt = qkv_v[:, :half].reshape(nW, SPLIT * H, half)
            kt = qkv_v[:, half:2 * half].reshape(nW, SPLIT * H, half)
            vt = qkv_v[:, 2 * half:].reshape(nW, SPLIT * H, half)
            a0t = cb._attn_auto(qt, kt, vt, h2, SCALE)
        if level >= 4:
            lepe0 = cb._lepe_windows(vt.reshape(nW, SPLIT, H, half), lk0[...], lb0[...],
                                     swap=True)
            a0t = a0t.reshape(nW, SPLIT, H, half).astype(jnp.float32) + lepe0
            a0t = a0t.astype(x.dtype).reshape(1, W, H, half)
            a0 = a0t.transpose(0, 2, 1, 3)
        if level == 3:
            acc += jnp.concatenate([a0t.reshape(W * H, half).astype(jnp.float32)] * 2, -1)
        elif level in (4, 5):
            acc += jnp.concatenate([a0.reshape(H * W, half).astype(jnp.float32)] * 2, -1)
        if level >= 5:
            q = qkv_h[:, :half].reshape(1, H, W, half)
            k = qkv_h[:, half:2 * half].reshape(1, H, W, half)
            v = qkv_h[:, 2 * half:].reshape(1, H, W, half)
            a1 = cb._branch_horizontal(q, k, v, lk1[...], lb1[...], H=H, W=W, sp=SPLIT,
                                       heads=h2, scale=SCALE)
            acc += jnp.concatenate([a1.reshape(H * W, half).astype(jnp.float32)] * 2, -1)
        if level >= 6:
            att = jnp.concatenate([a0.reshape(H * W, half), a1.reshape(H * W, half)], -1)
            x1 = x + cb._dot(att, projk[...], projb[...])
            acc += x1.astype(jnp.float32)
        if level >= 7:
            y = cb._layernorm(x1, n2s[...], n2b[...])
            y = cb._dot(y, fc1k[...], fc1b[...])
            yf = y.astype(jnp.float32)
            y = (yf * 0.5 * (1.0 + cb._erf(yf * (2.0 ** -0.5)))).astype(y.dtype)
            y = cb._dot(y, fc2k[...], fc2b[...])
            acc += (x1 + y).astype(jnp.float32)
        o_ref[...] = acc.astype(x_ref.dtype).reshape(1, H, W, C)

    return kern


@pytest.fixture(scope="module")
def inputs():
    """JAX-layout parameters (``exp_hb.mk_params``'s order), x, and the
    port's ``BlockParams`` of the same values."""
    rng = np.random.default_rng(11)
    mk = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    half = C // 2
    jp = [np.ones(C, np.float32) + mk(C, sc=0.1), mk(C, sc=0.1), mk(C, 3 * C),
          mk(3 * C, sc=0.1), mk(3, 3, half), mk(half, sc=0.1), mk(3, 3, half),
          mk(half, sc=0.1), mk(C, C), mk(C, sc=0.1), np.ones(C, np.float32) + mk(C, sc=0.1),
          mk(C, sc=0.1), mk(C, 4 * C), mk(4 * C, sc=0.1), mk(4 * C, C), mk(C, sc=0.1)]
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lk = lambda a: t(a.transpose(2, 0, 1)[:, None])
    tp = BlockParams(t(jp[0]), t(jp[1]), t(jp[2].T), t(jp[3]), lk(jp[4]), t(jp[5]),
                     lk(jp[6]), t(jp[7]), t(jp[8].T), t(jp[9]), t(jp[10]), t(jp[11]),
                     t(jp[12].T), t(jp[13]), t(jp[14].T), t(jp[15]))
    return jp, x, tp


def _script_level(level, jp, x) -> np.ndarray:
    (n1s, n1b, qkvk, qkvb, lk0, lb0, lk1, lb1, projk, projb, n2s, n2b, fc1k, fc1b, fc2k,
     fc2b) = (jnp.asarray(a) for a in jp)
    half = C // 2
    # the qkv weight split into the halves' columns as exp_cum.py's main splits it
    cols_v = jnp.concatenate([qkvk[:, :half], qkvk[:, C:C + half], qkvk[:, 2 * C:2 * C + half]], -1)
    cols_h = jnp.concatenate([qkvk[:, half:C], qkvk[:, C + half:2 * C], qkvk[:, 2 * C + half:]], -1)
    bv = jnp.concatenate([qkvb[:half], qkvb[C:C + half], qkvb[2 * C:2 * C + half]])
    bh = jnp.concatenate([qkvb[half:C], qkvb[C + half:2 * C], qkvb[2 * C + half:]])
    ps = (n1s, n1b, cols_h, bh, cols_v, bv, lk0, lb0, lk1, lb1, projk, projb, n2s, n2b,
          fc1k, fc1b, fc2k, fc2b)
    xx = jnp.asarray(x).astype(jnp.bfloat16)
    x_spec = pl.BlockSpec((1, H, W, C), lambda b: (b, 0, 0, 0))
    full = lambda s: pl.BlockSpec(tuple(s), lambda b: (0,) * len(s))
    out = pl.pallas_call(_level_kernel(level), grid=(B,),
                         in_specs=[x_spec, x_spec] + [full(p.shape) for p in ps],
                         out_specs=x_spec, out_shape=jax.ShapeDtypeStruct(xx.shape, xx.dtype),
                         interpret=True)(xx, xx.transpose(0, 2, 1, 3), *ps)
    return np.asarray(out.astype(jnp.float32), np.float64)


def _port(level, x, tp) -> np.ndarray:
    out = K.block_one(torch.from_numpy(x).bfloat16(), tp, heads=HEADS, split=SPLIT,
                      scale=SCALE, last_stage=False, level=level)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    return out.float().numpy().astype(np.float64)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("level", range(K.CUM_LEVELS))
def test_level_matches_the_script_composition(inputs, level):
    jp, x, tp = inputs
    got = _port(level, x, tp)
    assert _rel_l2(got, _script_level(level, jp, x)) <= TOL
    if level:
        assert _rel_l2(got, _port(level - 1, x, tp)) > TOL
