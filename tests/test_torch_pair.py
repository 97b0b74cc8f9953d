"""The pair route: two consecutive CSWin blocks through one ``block_pair``
launch, against the JAX pair kernel and the JAX model's pair routing.

On the CPU ``fused_block_pair`` runs ``block_pair_plain``, the chain's own
plain steps in the chain's order, so it equals two ``fused_cswin_block``
calls bit for bit. Against JAX (``_fused_block_pair_fwd`` in interpret
mode, and the JAX model with ``_pair_fuse_ok`` patched on): float32 rtol =
atol = 1e-4 per block pair and relative L2 <= 1e-4 for the model (different
summation orders); bf16 relative L2 <= 0.02; labels by the margin rule (a
mismatch counts only where the reference's top-2 logit gap exceeds
0.02·max|logit|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cswin_unet_tpu.ops.pallas.cswin_block as jax_block
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.models.cswin_unet import CSWinBlock
from cswin_unet_tpu_torch.ops.cuda import cswin_block
from cswin_unet_tpu_torch.ops.cuda.cswin_block import fused_block_pair, fused_cswin_block
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_block import _jax_params, _port_params

torch.set_num_threads(2)

PAIR_GEOMETRIES = [
    # (H, W, C, heads, split, g) — tests/test_fused_block.py's pair cases
    (8, 8, 16, 2, 2, 1),
    (8, 8, 32, 4, 4, 2),
]
# img 64: stage 2 (8x8, split 2, depth 3) holds one pair and one leftover
# block on each side; stage 1 and 3 one block, stage 4 the last stage.
GEOM = dict(img_size=64, in_chans=3, num_classes=4, embed_dim=32,
            depth=(1, 3, 1, 1), split_size=(1, 2, 2, 2), num_heads=(2, 4, 8, 16))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _margin_mismatches(labels, ref_logits):
    srt = np.sort(ref_logits, -1)
    margin = srt[..., -1] - srt[..., -2]
    thr = 0.02 * float(np.abs(ref_logits).max())
    return int(np.sum((labels != ref_logits.argmax(-1)) & (margin > thr)))


def _pair_case(H, W, C, heads, split, g, seed):
    rng = np.random.default_rng(seed)
    jp1, jp2 = _jax_params(rng, C, C // 2), _jax_params(rng, C, C // 2)
    x = rng.standard_normal((2 * g, H, W, C)).astype(np.float32)
    return x, (jp1, jp2), (_port_params(jp1, False), _port_params(jp2, False))


def _jax_pair(x, jps, H, W, C, heads, split, g):
    return np.asarray(jax_block._fused_block_pair_fwd(
        x, tuple(map(jnp.asarray, jps[0])), tuple(map(jnp.asarray, jps[1])), H=H, W=W,
        C=C, heads=heads, split=split, scale=(C // heads) ** -0.5, qkv_bias=True,
        g_images=g), np.float32)


@pytest.mark.parametrize("H,W,C,heads,split,g", PAIR_GEOMETRIES)
def test_pair_f32_matches_jax_pair_kernel(H, W, C, heads, split, g):
    x, jps, (p1, p2) = _pair_case(H, W, C, heads, split, g, seed=11)
    want = _jax_pair(jnp.asarray(x), jps, H, W, C, heads, split, g)
    got = fused_block_pair(torch.from_numpy(x), p1, p2, heads=heads, split=split,
                           scale=(C // heads) ** -0.5)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,W,C,heads,split,g", PAIR_GEOMETRIES)
def test_pair_bf16_matches_jax_pair_kernel(H, W, C, heads, split, g):
    x, jps, (p1, p2) = _pair_case(H, W, C, heads, split, g, seed=12)
    want = _jax_pair(jnp.asarray(x).astype(jnp.bfloat16), jps, H, W, C, heads, split, g)
    got = fused_block_pair(torch.from_numpy(x).bfloat16(), p1, p2, heads=heads,
                           split=split, scale=(C // heads) ** -0.5)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(), want) <= 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,heads,split,g", PAIR_GEOMETRIES)
def test_pair_equals_two_blocks_bit_for_bit(H, W, C, heads, split, g, dtype):
    x, _, (p1, p2) = _pair_case(H, W, C, heads, split, g, seed=13)
    xt = torch.from_numpy(x).to(dtype)
    kw = dict(heads=heads, split=split, scale=(C // heads) ** -0.5)
    pair = fused_block_pair(xt, p1, p2, **kw)
    two = fused_cswin_block(fused_cswin_block(xt, p1, last_stage=False, **kw), p2,
                            last_stage=False, **kw)
    assert torch.equal(pair, two)


def test_pair_refuses_gradients():
    x, _, (p1, p2) = _pair_case(8, 8, 16, 2, 2, 1, seed=14)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        fused_block_pair(xt, p1, p2, heads=2, split=2, scale=8 ** -0.5)


# ---------------------------------------------------------------------------
# the whole model with pairing on, against the JAX model with pairing on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="xla"))
    params = jax.jit(m.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 1)))
    return {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).standard_normal((2, 64, 64, 1)).astype(np.float32)


def Spy(fn):
    """``fn`` with a count of its calls in ``.calls`` (a plain function, so
    it binds as a method where it replaces one)."""
    def spy(*args, **kwargs):
        spy.calls += 1
        return fn(*args, **kwargs)

    spy.calls = 0
    return spy


def _port_model(params_flat, dtype, impl="fused", **geom):
    backbone = CSWinUNet(**dict(GEOM, **geom), dtype=dtype, impl=impl)
    if params_flat is not None:
        backbone.load_state_dict(params_from_jax(params_flat))
    return CSwinUnet(backbone).eval()


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_model_with_pairs_matches_jax_model_with_pairs(jax_params, images, monkeypatch,
                                                       dtype, jdtype):
    jax_pair = Spy(jax_block._fused_block_pair_fwd)
    monkeypatch.setattr(jax_block, "_pair_fuse_ok", lambda H, W, C: True)
    monkeypatch.setattr(jax_block, "_fused_block_pair_fwd", jax_pair)
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="fused", dtype=jdtype))
    tree = jax_ckpt.unflatten({k: jnp.asarray(v) for k, v in jax_params.items()})
    want = np.asarray(m.apply(tree, jnp.asarray(images), deterministic=True), np.float32)
    assert jax_pair.calls == 2  # stage 2's pair, encoder and decoder

    model = _port_model(jax_params, dtype)
    x = torch.from_numpy(images)
    with torch.inference_mode():
        unpaired = model(x)
        port_pair = Spy(cswin_block.fused_block_pair)
        monkeypatch.setattr(cswin_block, "pair_fuse_ok", lambda H, W, C, dtype=None: True)
        monkeypatch.setattr(cswin_block, "fused_block_pair", port_pair)
        got = model(x)
        labels = model(x, emit="labels")
    assert port_pair.calls == 4  # two forwards
    assert torch.equal(got, unpaired)  # the CPU pair is the chain's arithmetic
    got = got.numpy()
    assert np.all(np.isfinite(got)) and got.shape == (2, 64, 64, 4)
    assert _rel_l2(got, want) <= (1e-4 if dtype == torch.float32 else 0.02)
    assert _margin_mismatches(labels.numpy(), want) == 0


# ---------------------------------------------------------------------------
# routing: where the stage runner pairs, and where it must not
# ---------------------------------------------------------------------------

ROUTING = [
    # (case, geometry changes, impl, train, grad, forced) -> (pairs, single blocks)
    ("eval-no-grad", {}, "fused", False, False, True, 2, 8),
    ("routing-off", {}, "fused", False, False, False, 0, 12),
    ("train-mode", {}, "fused", True, False, True, 0, 12),
    ("eval-with-grad", {}, "fused", False, True, True, 0, 12),
    ("plain-route", {}, "plain", False, False, True, 0, 12),
    ("pallas-route", {}, "pallas", False, False, True, 0, 12),
    ("last-stage", dict(depth=(1, 1, 1, 2)), "fused", False, False, True, 0, 10),
    ("reso-equals-split", dict(depth=(1, 1, 2, 1), split_size=(1, 2, 4, 2)), "fused",
     False, False, True, 0, 10),
    ("even-stage", dict(depth=(2, 2, 1, 1)), "fused", False, False, True, 4, 4),
]


@pytest.mark.parametrize("case,geom,impl,train,grad,forced,pairs,singles", ROUTING,
                         ids=[r[0] for r in ROUTING])
def test_pair_routing(monkeypatch, case, geom, impl, train, grad, forced, pairs, singles):
    """Pairs run only on the fused route, in eval mode, without gradients,
    in dual-branch stages that ``pair_fuse_ok`` accepts; an odd block runs
    alone. Narrow widths (embed 16, head dim 8) through the plain steps."""
    torch.manual_seed(0)
    model = _port_model(None, torch.float32, impl, embed_dim=16, **geom).train(train)
    pair, single = Spy(cswin_block.fused_block_pair), Spy(CSWinBlock.forward)
    monkeypatch.setattr(cswin_block, "pair_fuse_ok", lambda H, W, C, dtype=None: forced)
    monkeypatch.setattr(cswin_block, "fused_block_pair", pair)
    monkeypatch.setattr(CSWinBlock, "forward", single)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 64, 64, 1)).astype(np.float32))
    with torch.set_grad_enabled(grad):
        out = model(x)
    assert (pair.calls, single.calls) == (pairs, singles)
    assert out.shape == (1, 64, 64, 4) and bool(torch.isfinite(out).all())
