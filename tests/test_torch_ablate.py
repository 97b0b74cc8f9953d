"""The one-block kernel's ablation variants (``block_one``'s plain version on
the CPU) against the body of ``scripts/ablate_block.py``.

The script is loaded from its file (its import only puts the repo on the
path) and its ``_kernel`` runs through ``pl.pallas_call(interpret=True)``
with plain block specs, one image per grid step, as its ``build`` runs it on
a TPU; ``_lepe_full`` rolls with ``pltpu.roll``, which lowers on the CPU
only inside Pallas. Seeded numpy weights at scale 0.3 (not the script's
0.05, under which the residual hides the parts) and x go to both.

Tolerance: bf16 relative L2 <= 0.02 on the block's output (the reference
gate's default; the script's erf is a polynomial, its LePE adds in float32
and rounds once). Each variant but ``no-transpose`` at the last stage (one
full window: nothing to transpose, the same function) moves the port's
output by more than that limit against ``full``, so a switch that does
nothing fails.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.ops.cuda.cswin_block import BlockParams

torch.set_num_threads(2)

TOL = 0.02
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (H, C, heads, split, last): a narrow dual-branch stage and a last stage
GEOMETRIES = {"dual": (8, 32, 2, 2, False), "last": (4, 32, 2, 4, True)}
CASES = ([("dual", v) for v in K.BLOCK_VARIANTS]
         + [("last", v) for v in ("full", "no-softmax", "no-attn", "no-transpose")])
SCRIPT_FLAGS = {  # the script's VARIANTS (ablate_block.py:220-230) by the port's names
    "full": {}, "no-lepe": {"lepe": False}, "no-transpose": {"transpose": False},
    "no-softmax": {"softmax": False}, "no-attn": {"attn": False}, "no-ln": {"ln": False},
    "no-gelu": {"gelu": False},
    "matmuls-only": {"lepe": False, "transpose": False, "softmax": False, "ln": False,
                     "gelu": False}}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "ablate_block", os.path.join(REPO, "scripts", "ablate_block.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(geometry: str):
    """JAX-layout parameters in the script's order, x, and the port's
    ``BlockParams`` of the same values."""
    H, C, heads, split, last = GEOMETRIES[geometry]
    cb = C if last else C // 2
    rng = np.random.default_rng(7)
    mk = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    jp = (np.ones(C, np.float32) + mk(C, sc=0.1), mk(C, sc=0.1),      # n1
          mk(C, 3 * C), mk(3 * C, sc=0.1),                             # qkv
          mk(3, 3, cb), mk(cb, sc=0.1), mk(3, 3, cb), mk(cb, sc=0.1),  # LePE 0, 1
          mk(C, C), mk(C, sc=0.1),                                     # proj
          np.ones(C, np.float32) + mk(C, sc=0.1), mk(C, sc=0.1),      # n2
          mk(C, 4 * C), mk(4 * C, sc=0.1), mk(4 * C, C), mk(C, sc=0.1))  # fc1, fc2
    x = rng.standard_normal((1, H, H, C)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lk = lambda a: t(a.transpose(2, 0, 1)[:, None])
    lepe1 = (jp[4], jp[5]) if last else (jp[6], jp[7])
    tp = BlockParams(t(jp[0]), t(jp[1]), t(jp[2].T), t(jp[3]), lk(jp[4]), t(jp[5]),
                     lk(lepe1[0]), t(lepe1[1]), t(jp[8].T), t(jp[9]), t(jp[10]), t(jp[11]),
                     t(jp[12].T), t(jp[13]), t(jp[14].T), t(jp[15]))
    return jp, x, tp


def _script_block(script, geometry: str, variant: str, jp, x) -> np.ndarray:
    H, C, heads, split, last = GEOMETRIES[geometry]
    flags = {**script.DEFAULT, **SCRIPT_FLAGS[variant]}
    kern = functools.partial(script._kernel, H=H, W=H, C=C, heads=heads, split=split,
                             last=last, scale=(C // heads) ** -0.5, flags=flags)
    params = [jnp.asarray(a) for a in jp]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    full = lambda shape: pl.BlockSpec(shape, lambda b: (0,) * len(shape))
    x_spec = pl.BlockSpec((1, H, H, C), lambda b: (b, 0, 0, 0))
    out = pl.pallas_call(kern, grid=(x.shape[0],),
                         in_specs=[x_spec] + [full(p.shape) for p in params],
                         out_specs=x_spec, out_shape=jax.ShapeDtypeStruct(xb.shape, xb.dtype),
                         interpret=True)(xb, *params)
    return np.asarray(out.astype(jnp.float32), np.float64)


def _port(geometry: str, variant: str, x, tp) -> torch.Tensor:
    H, C, heads, split, last = GEOMETRIES[geometry]
    return K.block_one(torch.from_numpy(x).bfloat16(), tp, heads=heads, split=split,
                       scale=(C // heads) ** -0.5, last_stage=last, variant=variant)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("geometry,variant", CASES)
def test_variant_matches_the_script_body(script, geometry, variant):
    jp, x, tp = _inputs(geometry)
    got = _port(geometry, variant, x, tp)
    want = _script_block(script, geometry, variant, jp, x)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_l2(got.float().numpy(), want) <= TOL, variant
    moved = _rel_l2(got.float().numpy(), _port(geometry, "full", x, tp).float().numpy())
    if geometry == "last" and variant == "no-transpose":
        assert moved == 0.0
    elif variant != "full":
        assert moved > TOL, (variant, moved)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_full_mask_is_the_chain(geometry):
    """With every part on, the one-block kernel's plain version is the block
    chain's (``fused_cswin_block`` on a CPU tensor) bit for bit."""
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import fused_cswin_block

    H, C, heads, split, last = GEOMETRIES[geometry]
    _, x, tp = _inputs(geometry)
    xb = torch.from_numpy(x).bfloat16()
    kw = dict(heads=heads, split=split, scale=(C // heads) ** -0.5, last_stage=last)
    assert torch.equal(K.block_one(xb, tp, **kw), fused_cswin_block(xb, tp, **kw))
