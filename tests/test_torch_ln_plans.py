"""The forward LayerNorm's instances (``layernorm_row.cuh``), in what the
CPU can check: ``kernels.layernorm_fwd_plan`` (lanes a row, 16-byte vectors
a lane, rows a CTA step) at every width of both configs, its refusals, and
``layernorm_plain`` (the function the kernel is held to on the card)
against the JAX block's ``_layernorm`` on seeded bf16 rows, within one bf16
ulp of the output, or of 2^-7 near zero (the frameworks sum the statistics
in different orders).
"""

import argparse
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.ops.pallas.cswin_block import _layernorm as jax_layernorm
from cswin_unet_tpu_torch import config as port_config
from cswin_unet_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _widths(yaml: str) -> list[int]:
    args = argparse.Namespace(cfg=os.path.join(REPO, "cswin_unet_tpu_torch", "configs", yaml),
                              opts=None)
    return [port_config.get_config(args).MODEL.CSWIN.EMBED_DIM * 2**s for s in range(4)]


def test_config_widths():
    assert _widths("cswin_tiny_224_lite.yaml") == [64, 128, 256, 512]
    assert _widths("cswin_base_384.yaml") == [96, 192, 384, 768]


@pytest.mark.parametrize("C", sorted(set(_widths("cswin_tiny_224_lite.yaml")
                                         + _widths("cswin_base_384.yaml")) | {8, 1024}))
def test_layernorm_fwd_plan_covers_the_row(C):
    p = K.layernorm_fwd_plan(C)
    n = C // 8
    assert p.lanes in (4, 8, 16, 32) and 1 <= p.vectors <= 4
    assert p.lanes * p.vectors >= n > p.lanes * (p.vectors - 1)  # no lane idles a vector
    assert p.lanes == 32 or p.lanes == 4 or p.lanes < 2 * n     # the fewest lanes
    assert p.rows_per_step == 256 // p.lanes
    want = {64: (8, 1), 96: (16, 1), 128: (16, 1), 192: (32, 1), 256: (32, 1),
            384: (32, 2), 512: (32, 2), 768: (32, 3), 1024: (32, 4), 8: (4, 1)}
    assert (p.lanes, p.vectors) == want[C]


@pytest.mark.parametrize("C", [0, 4, 100, 1028, 1032, 2048])
def test_layernorm_fwd_plan_refuses(C):
    with pytest.raises(ValueError, match="C % 8 == 0"):
        K.layernorm_fwd_plan(C)


@pytest.mark.parametrize("C", [96, 768])
def test_layernorm_plain_matches_jax(C):
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((333, C)) * 2 + 0.5).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    w = (rng.standard_normal(C) * 0.3 + 1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    got = K.layernorm_plain(xb, torch.from_numpy(w), torch.from_numpy(b)).float().numpy()
    want = np.asarray(jax_layernorm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                    jnp.asarray(w), jnp.asarray(b)).astype(jnp.float32))
    # at most one bf16 ulp of the output apart (2^-7 relative; near zero, where
    # + β cancels, an ulp of 2^-7), most equal
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0**-7)
    ulp = np.exp2(np.floor(np.log2(top)) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got == want).mean() > 0.95
