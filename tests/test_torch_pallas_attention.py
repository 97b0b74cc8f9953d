"""The ``pallas`` route against the JAX package's ``attn_impl="pallas"``.

* ``cswin_attention_pallas_plain`` (the plain version of the CUDA
  ``cswin_attention`` kernel, which the kernel wrapper runs on a CPU tensor)
  against the JAX ``cswin_attention_pallas`` (interpret mode) at vertical,
  horizontal and full windows: float32 relative L2 <= 1e-5 (the two sum
  the LePE taps in another order), bf16 <= 0.02 (the reference gate's
  default);
* ``CSWinAttentionFn``'s gradients against ``jax.grad`` through the JAX
  ``custom_vjp``: float32, rtol / atol 2e-4 (the JAX package's own
  Pallas-vs-XLA gradient tolerance, ``tests/test_pallas_attention.py``);
* the whole model with ``impl="pallas"`` against JAX
  ``attn_impl="pallas"`` (float32 relative L2 <= 1e-4, bf16 <= 0.02, labels
  by the margin rule), and the route chosen from the config.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.ops.attention import cswin_attention as jax_cswin_attention
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.config import get_config
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet, build_model
from cswin_unet_tpu_torch.ops.attention import (cswin_attention,
                                                cswin_attention_pallas_plain,
                                                cswin_attention_xla)
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, H, W, C, h_sp, w_sp, heads): vertical stripes, horizontal stripes,
# several windows each way, the last stage's full window.
WINDOWS = [(2, 8, 8, 16, 8, 1, 1), (2, 8, 8, 16, 1, 8, 1), (1, 8, 8, 32, 8, 2, 2),
           (1, 8, 8, 32, 2, 8, 2), (2, 4, 4, 32, 4, 4, 2)]
GEOM = dict(img_size=64, in_chans=3, num_classes=4, embed_dim=32,
            depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2), num_heads=(2, 4, 8, 16))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _case(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(3))
    lk = (rng.standard_normal((3, 3, 1, C)) * 0.3).astype(np.float32)  # HWIO
    lb = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return q, k, v, lk, lb


def _port_lepe(lk):
    return torch.from_numpy(np.ascontiguousarray(lk.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,W,C,hs,ws,heads", WINDOWS)
def test_pallas_plain_matches_jax_pallas(B, H, W, C, hs, ws, heads, dtype):
    q, k, v, lk, lb = _case(0, B, H, W, C)
    scale = (C // heads) ** -0.5
    jdt = jnp.dtype(dtype)
    want = jax_cswin_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               jnp.asarray(lk), jnp.asarray(lb), h_sp=hs, w_sp=ws,
                               num_heads=heads, scale=scale, impl="pallas")
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    kw = dict(h_sp=hs, w_sp=ws, num_heads=heads, scale=scale)
    got = cswin_attention_pallas_plain(qt, kt, vt, _port_lepe(lk), torch.from_numpy(lb), **kw)
    assert got.dtype == tdt and got.shape == (B, H, W, C)
    tol = 1e-5 if dtype == "float32" else 0.02
    assert _rel_l2(got.float(), np.asarray(want, np.float32)) <= tol
    # the kernel wrapper and the dispatcher run the same plain version on CPU
    for out in (K.cswin_attention(qt, kt, vt, _port_lepe(lk), torch.from_numpy(lb), **kw),
                cswin_attention(qt, kt, vt, _port_lepe(lk), torch.from_numpy(lb),
                                impl="pallas", **kw)):
        assert torch.equal(out, got)
    assert K.cswin_attention.launches == 0


def test_pallas_rounding_differs_from_the_composition():
    """In bf16 the two roundings are different functions: the kernel's
    oracle is not ``cswin_attention_xla``."""
    q, k, v, lk, lb = _case(1, 1, 8, 8, 32)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    kw = dict(h_sp=8, w_sp=2, num_heads=2, scale=16 ** -0.5)
    pal = cswin_attention_pallas_plain(*args, _port_lepe(lk), torch.from_numpy(lb), **kw)
    xla = cswin_attention_xla(*args, _port_lepe(lk), torch.from_numpy(lb), **kw)
    assert not torch.equal(pal, xla) and _rel_l2(pal.float(), xla.float()) < 0.02


@pytest.mark.parametrize("B,H,W,C,hs,ws,heads", WINDOWS[1:3])
@pytest.mark.parametrize("bias", [True, False])
def test_attention_fn_grads_match_jax(B, H, W, C, hs, ws, heads, bias):
    q, k, v, lk, lb = _case(2, B, H, W, C)
    scale = (C // heads) ** -0.5
    kw = dict(h_sp=hs, w_sp=ws, num_heads=heads, scale=scale)
    g = np.random.default_rng(3).standard_normal((B, H, W, C)).astype(np.float32)

    def jloss(q, k, v, lk, lb):
        out = jax_cswin_attention(q, k, v, lk, lb if bias else None, impl="pallas", **kw)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (q, k, v, lk, lb)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    leaves += [_port_lepe(lk).requires_grad_(), torch.from_numpy(lb).requires_grad_()]
    out = cswin_attention(*leaves[:4], leaves[4] if bias else None, impl="pallas", **kw)
    assert out.grad_fn is not None and "CSWinAttentionFn" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    for i, (leaf, w) in enumerate(zip(leaves[:4], want[:4])):
        w = np.asarray(w)
        if i == 3:
            w = w.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=2e-4, atol=2e-4)
    if bias:
        np.testing.assert_allclose(leaves[4].grad.numpy(), np.asarray(want[4]),
                                   rtol=2e-4, atol=2e-4)
    else:
        assert leaves[4].grad is None


@pytest.fixture(scope="module")
def jax_params():
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="xla"))
    params = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    return {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}


def _margin_mismatches(labels, ref_logits):
    srt = np.sort(ref_logits, -1)
    margin = srt[..., -1] - srt[..., -2]
    thr = 0.02 * float(np.abs(ref_logits).max())
    return int(np.sum((labels != ref_logits.argmax(-1)) & (margin > thr)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_pallas_route_matches_jax(jax_params, dtype):
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 1)).astype(np.float32)
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="pallas",
                                           dtype=jnp.dtype(dtype)))
    params = jax_ckpt.unflatten({k: jnp.asarray(v) for k, v in jax_params.items()})
    want = np.asarray(m.apply(params, jnp.asarray(x), deterministic=True), np.float32)
    backbone = CSWinUNet(**GEOM, dtype=getattr(torch, dtype), impl="pallas")
    backbone.load_state_dict(params_from_jax(jax_params))
    model = CSwinUnet(backbone).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        labels = model(torch.from_numpy(x), emit="labels").numpy()
    assert _rel_l2(got, want) <= (1e-4 if dtype == "float32" else 0.02)
    assert _margin_mismatches(labels, want) == 0
    assert K.cswin_attention.launches == 0 and K.stripe_attention.launches == 0


def test_pallas_route_trains_like_the_plain_route(jax_params):
    """Train mode (drop-path 0), float32: every gradient of the ``pallas``
    route, whose attention backward is ``CSWinAttentionFn``'s, within 1e-4
    of the plain route's."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 64, 1)).astype(np.float32))
    grads = {}
    for impl in ("pallas", "plain"):
        backbone = CSWinUNet(**GEOM, dtype=torch.float32, impl=impl)
        backbone.load_state_dict(params_from_jax(jax_params))
        model = CSwinUnet(backbone).train()
        loss = (model(x) ** 2).mean()
        names, params = zip(*model.named_parameters())
        grads[impl] = dict(zip(names, torch.autograd.grad(loss, params)))
    for name, g in grads["plain"].items():
        assert _rel_l2(grads["pallas"][name], g) <= 1e-4, name


@pytest.mark.parametrize("opts,route", [
    (None, "fused"), (["TPU.ATTN_IMPL", "pallas"], "pallas"),
    (["TPU.ATTN_IMPL", "xla"], "plain"),
    (["TPU.ATTN_IMPL", "pallas", "TPU.USE_PALLAS_ATTENTION", "False"], "plain")])
def test_build_model_takes_the_route_from_config(opts, route):
    args = argparse.Namespace(cfg=os.path.join(REPO, "cswin_unet_tpu_torch", "configs",
                                               "cswin_tiny_224_lite.yaml"),
                              opts=["MODEL.CSWIN.DEPTH", "[1,1,1,1]", "MODEL.CSWIN.EMBED_DIM",
                                    "16", "MODEL.CSWIN.NUM_HEADS", "[1,1,1,1]"]
                              + (opts or []))
    model = build_model(get_config(args), img_size=32, num_classes=4, device="cpu")
    assert model.cswin_unet.impl == route
    assert model.cswin_unet.stage1[0].impl == route
    assert build_model(get_config(args), img_size=32, num_classes=4, device="cpu",
                       impl="plain").cswin_unet.impl == "plain"
