"""base-384 (``configs/cswin_base_384.yaml``) in the port.

The whole port model at base-384's window geometry, narrowed: img 384 (stage
resolutions 96 / 48 / 24 / 12), split 1 / 2 / 12 / 12, head dim 24 at every
stage (embed 48, heads 2 / 4 / 8 / 16), depths 1 / 1 / 1 / 1, 9 classes,
batch 1. So every window the full config gives (96 x 1, 48 x 2, 24 x 12,
12 x 12: L = 96, 96, 288, 144) and both fused CARAFE sites (``upsample2``
48 -> 96, the x4 tail at 96) run, against the JAX model (``attn_impl="xla"``,
jitted) on weights carried by ``params_from_jax``. Tolerances as
``tests/test_torch_model.py``: float32 relative L2 <= 1e-4, bf16 <= 0.02,
labels by the margin rule.

Then the launch counts ``chip_smoke.py`` holds the card to, from the full
config: a serving forward and a train step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.config import get_config
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

BASE384 = "cswin_unet_tpu_torch/configs/cswin_base_384.yaml"
GEOM = dict(img_size=384, in_chans=3, num_classes=9, embed_dim=48, depth=(1, 1, 1, 1),
            split_size=(1, 2, 12, 12), num_heads=(2, 4, 8, 16))


@pytest.fixture(scope="module")
def jax_params():
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="xla"))
    params = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 384, 384, 1)))
    return {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).standard_normal((1, 384, 384, 1)).astype(np.float32)


def _jax_logits(params_flat, x, dtype):
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="xla", dtype=dtype))
    params = jax_ckpt.unflatten({k: jnp.asarray(v) for k, v in params_flat.items()})
    apply = jax.jit(lambda p, xx: m.apply(p, xx, deterministic=True))
    return np.asarray(apply(params, jnp.asarray(x)), np.float32)


def _port(params_flat, impl, dtype):
    backbone = CSWinUNet(**GEOM, dtype=dtype, impl=impl)
    backbone.load_state_dict(params_from_jax(params_flat))
    return CSwinUnet(backbone).eval()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _margin_mismatches(labels, ref_logits):
    srt = np.sort(ref_logits, -1)
    margin = srt[..., -1] - srt[..., -2]
    thr = 0.02 * float(np.abs(ref_logits).max())
    return int(np.sum((labels != ref_logits.argmax(-1)) & (margin > thr)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.02)])
def test_base384_geometry_matches_jax(jax_params, image, dtype, tol):
    want = _jax_logits(jax_params, image, getattr(jnp, dtype))
    assert want.shape == (1, 384, 384, 9)
    for impl in ("fused", "plain"):
        model = _port(jax_params, impl, getattr(torch, dtype))
        with torch.inference_mode():
            got = model(torch.from_numpy(image)).numpy()
            labels = model(torch.from_numpy(image), emit="labels").numpy()
        assert np.all(np.isfinite(got)) and labels.dtype == np.int32
        assert _rel_l2(got, want) <= tol, (impl, _rel_l2(got, want))
        assert _margin_mismatches(labels, want) == 0, impl


def _base384():
    class _Args:
        cfg = BASE384
        opts = None

    return get_config(_Args)


def test_base384_config():
    cfg = _base384()
    cs = cfg.MODEL.CSWIN
    assert (cfg.DATA.IMG_SIZE, cs.EMBED_DIM, tuple(cs.DEPTH), tuple(cs.NUM_HEADS),
            tuple(cs.SPLIT_SIZE), cfg.MODEL.DROP_PATH_RATE) == \
        (384, 96, (2, 4, 32, 2), (4, 8, 16, 32), (1, 2, 12, 12), 0.5)
    geoms = [(g["H"], g["C"], g["C"] // g["heads"], g["last"])
             for g in chip_smoke.stage_geometries(cfg)]
    assert geoms == [(96, 96, 24, False), (48, 192, 24, False), (24, 384, 24, False),
                     (12, 768, 24, True)]
    assert chip_smoke.carafe_sites(cfg) == [(48, 192, 96, 2), (96, 96, 96, 4)]


def test_base384_expected_launches():
    """A serving forward: 80 blocks as chains (no base-384 geometry is
    paired), 2 LN and 4 GEMMs a block, an attention launch a branch, the two
    fused CARAFE sites a GEMM and a CARAFE launch each. A train step: every
    block through ``CSWinBlockFn`` (the last stage's 4 blocks one attention
    launch each way), the kernels' backward as many times as their
    forward."""
    cfg = _base384()
    zero = dict.fromkeys(chip_smoke.SOURCES, 0)
    assert chip_smoke.expected_launches(cfg, 1) == dict(
        zero, layernorm=160, gemm=322, stripe_attention=156, carafe_reassemble=2)
    assert chip_smoke.expected_train_launches(cfg, 1) == dict(
        zero, layernorm=160, gemm=322, stripe_attention=156, carafe_reassemble=2,
        layernorm_bwd=160, gemm_dgrad=320, gemm_wgrad=320, stripe_attention_bwd=156)
