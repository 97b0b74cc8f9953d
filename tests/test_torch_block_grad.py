"""The port's block backward (``CSWinBlockFn`` on the CPU, i.e. through each
backward kernel's plain version) against ``jax.grad`` through the JAX fused
block, whose backward at H >= 28 is the hand-written Pallas kernel
``_fused_block_bwd_xt`` (interpret mode here), as
tests/test_fused_block.py:267-336 runs it.

Also each backward kernel's plain version against torch autograd of its
plain forward. Tolerances: float32 rtol = atol = 2e-4 (the JAX backward
test's); bf16 relative L2 error <= 0.02 (the reference gate's default).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cswin_unet_tpu.ops.pallas.cswin_block import fused_cswin_block as jax_fused
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.ops.cuda.cswin_block import (BlockParams, CSWinBlockFn,
                                                       composed_block,
                                                       fused_cswin_block)

torch.set_num_threads(2)

H = W = 32
C, HEADS = 16, 2
SCALE = (C // HEADS) ** -0.5


def _jax_params(rng):
    def mk(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    cb = C // 2
    return (mk(C, s=0.3) + 1.0, mk(C), mk(C, 3 * C), mk(3 * C), mk(3, 3, cb),
            mk(cb), mk(3, 3, cb), mk(cb), mk(C, C), mk(C), mk(C, s=0.3) + 1.0,
            mk(C), mk(C, 4 * C), mk(4 * C), mk(4 * C, C), mk(C))


def _to_port(jp):
    """JAX 16-tuple (Dense (in, out), LePE (3, 3, cb)) -> torch layouts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lepe = lambda k: t(k.transpose(2, 0, 1)[:, None])
    (n1s, n1b, qk, qb, lk0, lb0, lk1, lb1, pk, pb, n2s, n2b,
     f1k, f1b, f2k, f2b) = jp
    return [t(n1s), t(n1b), t(qk.T), t(qb), lepe(lk0), t(lb0), lepe(lk1), t(lb1),
            t(pk.T), t(pb), t(n2s), t(n2b), t(f1k.T), t(f1b), t(f2k.T), t(f2b)]


def _to_jax_layout(grads):
    """Port gradients (torch layouts) -> JAX layouts, as numpy."""
    g = [np.asarray(t.detach().float().numpy()) for t in grads]
    lepe = lambda k: k[:, 0].transpose(1, 2, 0)
    return [g[0], g[1], g[2].T, g[3], lepe(g[4]), g[5], lepe(g[6]), g[7], g[8].T,
            g[9], g[10], g[11], g[12].T, g[13], g[14].T, g[15]]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _case(split, droppath, seed):
    rng = np.random.default_rng(seed)
    jp = _jax_params(rng)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    g = rng.standard_normal((2, H, W, C)).astype(np.float32)
    dps = ((np.array([0.0, 1.25], np.float32), np.array([1.25, 1.25], np.float32))
           if droppath else None)
    return jp, x, g, dps


def _jax_grads(jp, x, g, dps, split, dtype):
    jdps = None if dps is None else tuple(jnp.asarray(d[:, None]) for d in dps)
    fn = lambda a, p: jax_fused(a, p, jdps, H, W, C, HEADS, split, False, SCALE, True)
    out, vjp = jax.vjp(fn, jnp.asarray(x).astype(dtype), tuple(map(jnp.asarray, jp)))
    gx, gp = vjp(jnp.asarray(g).astype(dtype))
    return ([np.asarray(out, np.float32), np.asarray(gx, np.float32)]
            + [np.asarray(t, np.float32) for t in gp])


def _port_grads(fn, jp, x, g, dps, split, dtype):
    params = [t.requires_grad_() for t in _to_port(jp)]
    xx = torch.from_numpy(x).to(dtype).requires_grad_()
    tdps = None if dps is None else tuple(map(torch.from_numpy, dps))
    out = fn(xx, BlockParams(*params), heads=HEADS, split=split, last_stage=False,
             scale=SCALE, dps=tdps)
    out.backward(torch.from_numpy(g).to(dtype))
    return ([out.detach().float().numpy(), xx.grad.float().numpy()]
            + _to_jax_layout([p.grad for p in params]))


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("droppath", [True, False])
def test_block_fn_f32_matches_jax_bwd_kernel(split, droppath, monkeypatch):
    calls = []
    apply = CSWinBlockFn.apply
    monkeypatch.setattr(CSWinBlockFn, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    jp, x, g, dps = _case(split, droppath, seed=11 + split)
    want = _jax_grads(jp, x, g, dps, split, jnp.float32)
    got = _port_grads(fused_cswin_block, jp, x, g, dps, split, torch.float32)
    assert calls == [1]  # the gradient came from the Function's backward
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=str(i))


@pytest.mark.parametrize("split,droppath", [(1, True), (2, False)])
def test_block_fn_bf16_matches_jax_bwd_kernel(split, droppath):
    jp, x, g, dps = _case(split, droppath, seed=21 + split)
    want = _jax_grads(jp, x, g, dps, split, jnp.bfloat16)
    got = _port_grads(fused_cswin_block, jp, x, g, dps, split, torch.bfloat16)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel_l2(a, b) <= 0.02, (i, _rel_l2(a, b))


def test_composed_block_droppath_matches_function():
    """The plain composition with drop-path (the route of the blocks the
    Function does not take) gives the Function's gradients."""
    jp, x, g, dps = _case(2, True, seed=5)
    a = _port_grads(fused_cswin_block, jp, x, g, dps, 2, torch.float32)
    b = _port_grads(composed_block, jp, x, g, dps, 2, torch.float32)
    for i, (u, v) in enumerate(zip(a, b)):
        np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-5, err_msg=str(i))


# ---------------------------------------------------------------------------
# each backward kernel's plain version against autograd of its plain forward
# ---------------------------------------------------------------------------

def _t(rng, *shape, sc=1.0, off=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * sc + off).astype(np.float32))


def _autograd(fn, inputs, cot):
    leaves = [t.clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def test_layernorm_bwd_plain_matches_autograd():
    rng = np.random.default_rng(0)
    x, dy, res = _t(rng, 50, 32), _t(rng, 50, 32), _t(rng, 50, 32)
    w, b = _t(rng, 32, sc=0.3, off=1.0), _t(rng, 32, sc=0.1)
    dx, dw, db = K.layernorm_bwd(x, dy, w, residual=res)
    gx, gw, gb = _autograd(K.layernorm_plain, (x, w, b), dy)
    for got, want in ((dx, gx + res), (dw, gw), (db, gb)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("droppath", [True, False])
def test_gemm_bwd_plain_matches_autograd(droppath):
    rng = np.random.default_rng(1)
    M, N, Kd, hw = 24, 40, 16, 6
    a, res, gout = _t(rng, M, Kd), _t(rng, M, N), _t(rng, M, N)
    w, bias = _t(rng, N, Kd, sc=0.3), _t(rng, N, sc=0.1)
    dp = torch.tensor([0.0, 1.25, 1.25, 0.8]) if droppath else None
    kw = dict(dp=dp, rows_per_sample=hw)
    # residual epilogue: out = res + dp·(a·wᵀ + b)
    ga, gw, gb = _autograd(lambda a_, w_, b_: K.gemm_plain(
        a_, w_, b_, residual=res, epilogue="residual", **kw), (a, w, bias), gout)
    torch.testing.assert_close(K.gemm_dgrad(gout, w, **kw), ga, rtol=1e-5, atol=1e-5)
    dw, db = K.gemm_wgrad(a, gout, **kw)
    torch.testing.assert_close(dw, gw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, gb, rtol=1e-5, atol=1e-5)


def test_gemm_gelu_epilogue_and_gelu_bwd_plain_match_autograd():
    """fc1 (GELU epilogue, pre-activation kept) then fc2: the dX product of
    fc2 with the GELU-backward epilogue gives autograd's gradient at the
    fc1 pre-activation."""
    rng = np.random.default_rng(2)
    y, w1, b1 = _t(rng, 20, 8), _t(rng, 32, 8, sc=0.5), _t(rng, 32, sc=0.1)
    w2, gout = _t(rng, 8, 32, sc=0.3), _t(rng, 20, 8)
    pre = torch.empty(20, 32)
    K.gemm(y, w1, b1, epilogue="gelu", pre=pre)
    torch.testing.assert_close(pre, y @ w1.t() + b1, rtol=1e-6, atol=1e-6)
    (gh,) = _autograd(lambda h: F.gelu(h) @ w2.t(), (pre,), gout)
    torch.testing.assert_close(K.gemm_dgrad(gout, w2, gelu_h=pre), gh,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h_sp,w_sp,heads,off", [(8, 2, 2, 0), (2, 8, 1, 8),
                                                  (8, 8, 2, 0)])
def test_stripe_attention_bwd_plain_matches_autograd(h_sp, w_sp, heads, off):
    rng = np.random.default_rng(3)
    B, Hh, Ww, Cc = 2, 8, 8, 16
    cb = Cc - off if off else (Cc if (h_sp, w_sp) == (Hh, Ww) else Cc // 2)
    qkv, dout = _t(rng, B, Hh, Ww, 3 * Cc), _t(rng, B, Hh, Ww, Cc)
    lw, lb = _t(rng, cb, 1, 3, 3, sc=0.3), _t(rng, cb, sc=0.1)
    kw = dict(ch_off=off, heads=heads, h_sp=h_sp, w_sp=w_sp, scale=0.3)
    sl = slice(off, off + cb)

    def fwd(q, w, b):
        out = torch.zeros(B, Hh, Ww, Cc)
        return K.stripe_attention_plain(q, w, b, out, **kw)[..., sl]

    gq, gw, gb = _autograd(fwd, (qkv, lw, lb), dout[..., sl])
    dqkv = torch.zeros(B, Hh, Ww, 3 * Cc)
    dw, db = K.stripe_attention_bwd(qkv, dout, lw, dqkv, **kw)
    chans = torch.cat([torch.arange(off, off + cb) + i * Cc for i in range(3)])
    torch.testing.assert_close(dqkv[..., chans], gq[..., chans], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, gw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, gb, rtol=1e-5, atol=1e-5)
