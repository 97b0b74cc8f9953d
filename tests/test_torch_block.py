"""Port's CSWin block (kernel chain on the CPU, i.e. through each kernel's
plain version, and the plain ``composed_block``) against the JAX fused
Pallas block (interpret mode) and the JAX ``composed_block``.

Geometries are the dual-branch and last-stage rows of test_fused_block.py:
both stripe orientations, split 1 and split > 1, the full-window last stage
and the base-384 window patterns. Tolerances: float32 rtol = atol = 1e-4
(different summation orders, O(1) values); bf16 relative L2 error <= 0.02
(the reference gate's default).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.ops.pallas.cswin_block import _fused_block_fwd
from cswin_unet_tpu.ops.pallas.cswin_block import composed_block as jax_composed
from cswin_unet_tpu_torch.ops.cuda.cswin_block import (BlockParams,
                                                       composed_block,
                                                       fused_cswin_block)

torch.set_num_threads(2)

GEOMETRIES = [
    # (H, W, C, heads, split, last, g) — rows of test_fused_block.GEOMETRIES
    (8, 8, 16, 2, 1, False, 1),
    (8, 8, 16, 2, 2, False, 1),
    (8, 8, 32, 4, 4, False, 2),
    (4, 4, 32, 4, 4, True, 2),
    (24, 24, 32, 4, 12, False, 1),
    (12, 12, 32, 4, 12, True, 1),
]


def _jax_params(rng, C, cb):
    def mk(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return (
        mk(C, s=0.3) + 1.0, mk(C),
        mk(C, 3 * C), mk(3 * C),
        mk(3, 3, cb), mk(cb),
        mk(3, 3, cb), mk(cb),
        mk(C, C), mk(C),
        mk(C, s=0.3) + 1.0, mk(C),
        mk(C, 4 * C), mk(4 * C),
        mk(4 * C, C), mk(C),
    )


def _port_params(jp, last):
    """JAX 16-tuple (Dense (in, out), LePE (3, 3, cb)) -> torch layouts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lepe = lambda k: t(k.transpose(2, 0, 1)[:, None])
    (n1s, n1b, qk, qb, lk0, lb0, lk1, lb1, pk, pb, n2s, n2b,
     f1k, f1b, f2k, f2b) = jp
    if last:
        lk1, lb1 = lk0, lb0
    return BlockParams(t(n1s), t(n1b), t(qk.T), t(qb), lepe(lk0), t(lb0),
                       lepe(lk1), t(lb1), t(pk.T), t(pb), t(n2s), t(n2b),
                       t(f1k.T), t(f1b), t(f2k.T), t(f2b))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _case(H, W, C, heads, split, last, g, seed):
    rng = np.random.default_rng(seed)
    jp = _jax_params(rng, C, C if last else C // 2)
    x = rng.standard_normal((2 * g, H, W, C)).astype(np.float32)
    return x, jp, _port_params(jp, last), (C // heads) ** -0.5


@pytest.mark.parametrize("H,W,C,heads,split,last,g", GEOMETRIES)
def test_block_f32_matches_jax(H, W, C, heads, split, last, g):
    x, jp, pp, scale = _case(H, W, C, heads, split, last, g, seed=42)
    kw = dict(heads=heads, split=split, last_stage=last, scale=scale)
    jparams = tuple(map(jnp.asarray, jp))
    want = np.asarray(jax_composed(jnp.asarray(x), jparams, H, W, C, heads,
                                   split, last, scale, True))
    chain = fused_cswin_block(torch.from_numpy(x), pp, **kw).numpy()
    plain = composed_block(torch.from_numpy(x), pp, **kw).numpy()
    np.testing.assert_allclose(chain, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(plain, want, rtol=1e-4, atol=1e-4)
    pallas = np.asarray(_fused_block_fwd(
        jnp.asarray(x), jparams, H=H, W=W, C=C, heads=heads, split=split,
        last_stage=last, scale=scale, qkv_bias=True))
    np.testing.assert_allclose(chain, pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,W,C,heads,split,last,g", GEOMETRIES)
def test_block_bf16_matches_jax(H, W, C, heads, split, last, g):
    x, jp, pp, scale = _case(H, W, C, heads, split, last, g, seed=7)
    kw = dict(heads=heads, split=split, last_stage=last, scale=scale)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jparams = tuple(map(jnp.asarray, jp))
    pallas = np.asarray(_fused_block_fwd(
        xb, jparams, H=H, W=W, C=C, heads=heads, split=split, last_stage=last,
        scale=scale, qkv_bias=True), np.float32)
    composed = np.asarray(jax_composed(xb, jparams, H, W, C, heads, split, last,
                                       scale, True), np.float32)
    tx = torch.from_numpy(x).bfloat16()
    chain = fused_cswin_block(tx, pp, **kw)
    plain = composed_block(tx, pp, **kw)
    assert chain.dtype == plain.dtype == torch.bfloat16
    assert _rel_l2(chain.float().numpy(), pallas) <= 0.02
    assert _rel_l2(plain.float().numpy(), composed) <= 0.02


def test_gemm_operand_rule_has_no_m_grid_limit():
    """The GEMM's grid walks M and N tiles on one axis: M past 65535 tiles
    of 64 rows passes the wrapper's operand rule; K % 8, alignment and 2^31
    tiles are still refused (stride-0 views, nothing allocated)."""
    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    w = torch.zeros(64, 8, dtype=torch.bfloat16)
    row = torch.zeros(1, 8, dtype=torch.bfloat16)
    K._check_gemm_operands(row.expand(65535 * 64 + 1, 8), w)
    K._check_gemm_operands(row.expand(2**24, 8), w)
    with pytest.raises(ValueError, match="grid limit"):
        K._check_gemm_operands(row.expand(2**31, 8), torch.zeros(8192, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="K % 8"):
        K._check_gemm_operands(torch.zeros(4, 12, dtype=torch.bfloat16),
                               torch.zeros(4, 12, dtype=torch.bfloat16))
