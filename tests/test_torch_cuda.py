"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: these skip on a machine without an NVIDIA GPU (a CUDA
kernel has no CPU mode; the CPU tests cover each kernel's plain version
against the JAX package). On the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which this file does
not need.)

Tolerance: relative L2 error <= 0.02 in bf16 (the reference gate's
default); labels by the margin rule (a mismatch counts only where the plain
top-2 logit gap exceeds 0.02·max|logit|).
"""

import os

import numpy as np
import pytest
import torch

from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.ops.cuda.carafe_tail import (carafe_tail,
                                                       carafe_tail_argmax,
                                                       carafe_tail_plain,
                                                       carafe_up,
                                                       carafe_up_plain)
from cswin_unet_tpu_torch.ops.cuda.cswin_block import (BlockParams,
                                                       composed_block,
                                                       fused_cswin_block)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rnd(rng, dev, *shape, sc=1.0, off=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * sc + off)
                            .astype(np.float32)).to(dev)


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("M,C", [(1000, 64), (333, 512)])
def test_layernorm(dev, M, C):
    rng = np.random.default_rng(0)
    x = _rnd(rng, dev, M, C).bfloat16()
    w, b = _rnd(rng, dev, C, sc=0.3, off=1.0), _rnd(rng, dev, C, sc=0.1)
    before = K.layernorm.launches
    got = K.layernorm(x, w, b)
    assert K.layernorm.launches == before + 1
    assert _rel_l2(got.float(), K.layernorm_plain(x, w, b).float()) <= 0.02


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference of two bf16 tensors in bf16 ulps: the spacing
    of bf16 at the larger magnitude of the pair, and at least at 2^-7 (an
    O(1) output such as LN's, whose + β cancels near zero)."""
    g, w = got.float(), want.float()
    top = torch.maximum(torch.maximum(g.abs(), w.abs()), torch.tensor(2.0**-7, device=g.device))
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(top)) - 7)).max())


@pytest.mark.parametrize("C", [64, 96, 128, 192, 256, 384, 512, 768])
@pytest.mark.parametrize("rows", [1, 3001])
def test_layernorm_widths(dev, C, rows):
    """Every stage width of tiny-224 and base-384; 3001 rows is no multiple
    of any instance's rows a CTA step (8 to 64)."""
    p = K.layernorm_fwd_plan(C)
    assert rows == 1 or rows % p.rows_per_step
    rng = np.random.default_rng(C + rows)
    x = _rnd(rng, dev, rows, C, sc=2.0, off=0.5).bfloat16()
    w, b = _rnd(rng, dev, C, sc=0.3, off=1.0), _rnd(rng, dev, C, sc=0.1)
    got, want = K.layernorm(x, w, b), K.layernorm_plain(x, w, b)
    ulps = _bf16_ulps(got, want)
    print(f"layernorm C={C} rows={rows} (lanes {p.lanes}, vectors {p.vectors}): "
          f"rel_l2={_rel_l2(got.float(), want.float()):.3e} max {ulps:g} bf16 ulps")
    assert _rel_l2(got.float(), want.float()) <= 0.02
    assert K.layernorm(x, w, b).equal(got)  # a fixed sum order


@pytest.mark.parametrize("C", [60, 1032])
def test_layernorm_refuses_other_widths(dev, C):
    x = torch.zeros(4, C, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="C % 8 == 0"):
        K.layernorm(x, torch.ones(C, device=dev), torch.zeros(C, device=dev))


@pytest.mark.parametrize("epilogue", ["bias", "residual", "gelu"])
@pytest.mark.parametrize("M,N,K_", [(200, 96, 64), (130, 25, 64), (64, 512, 2048)])
def test_gemm(dev, M, N, K_, epilogue):
    rng = np.random.default_rng(1)
    a = _rnd(rng, dev, M, K_).bfloat16()
    w = _rnd(rng, dev, N, K_, sc=K_ ** -0.5).bfloat16()
    bias = _rnd(rng, dev, N, sc=0.1)
    res = _rnd(rng, dev, M, N).bfloat16() if epilogue == "residual" else None
    got = K.gemm(a, w, bias, residual=res, epilogue=epilogue)
    want = K.gemm_plain(a, w, bias, residual=res, epilogue=epilogue)
    assert _rel_l2(got.float(), want.float()) <= 0.02


GEMM_EPILOGUES = ["bias", "residual", "residual-droppath", "gelu", "gelu-keep-pre",
                  "dgrad", "dgrad-droppath", "dgrad-droppath-gelu"]


@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
@pytest.mark.parametrize("N", [25, 96, 192, 256, 2048])
@pytest.mark.parametrize("K_", [64, 256, 2048])
def test_gemm_tile(dev, K_, N, epilogue):
    """The GEMM tile (``gemm`` and ``gemm_dgrad``) at depths 64-2048 and
    widths from the tail's 25 classes (odd: scalar stores) to 2048, on a
    ragged M of 333 rows (9 samples of 37), in every epilogue: bias,
    residual with and without the per-sample drop-path multiplier, GELU
    with and without its kept pre-activation, and the dX product with the
    operand scale (A_SCALED) and the GELU backward."""
    rng = np.random.default_rng(21)
    M, hw = 333, 37
    dp = torch.from_numpy((rng.random(M // hw) < 0.7).astype(np.float32) / 0.7).to(dev)
    a = _rnd(rng, dev, M, K_).bfloat16()
    if epilogue.startswith("dgrad"):
        w = _rnd(rng, dev, K_, N, sc=K_ ** -0.5)
        kw = dict(rows_per_sample=hw)
        if "droppath" in epilogue:
            kw["dp"] = dp
        if epilogue.endswith("gelu"):
            kw["gelu_h"] = _rnd(rng, dev, M, N).bfloat16()
        before = K.gemm_dgrad.launches
        got, want = K.gemm_dgrad(a, w, **kw), K.gemm_dgrad_plain(a, w, **kw)
        assert K.gemm_dgrad.launches == before + 1
    else:
        w = _rnd(rng, dev, N, K_, sc=K_ ** -0.5).bfloat16()
        bias = _rnd(rng, dev, N, sc=0.1)
        kw = dict(epilogue=epilogue.split("-")[0])
        if epilogue.startswith("residual"):
            kw["residual"] = _rnd(rng, dev, M, N).bfloat16()
        if epilogue == "residual-droppath":
            kw.update(dp=dp, rows_per_sample=hw)
        pres = [None, None]
        if epilogue == "gelu-keep-pre":
            pres = [torch.empty(M, N, dtype=torch.bfloat16, device=dev) for _ in range(2)]
        before = K.gemm.launches
        got = K.gemm(a, w, bias, pre=pres[0], **kw)
        assert K.gemm.launches == before + 1
        want = K.gemm_plain(a, w, bias, pre=pres[1], **kw)
        if pres[0] is not None:
            assert _rel_l2(pres[0].float(), pres[1].float()) <= 0.02
    assert got.shape == want.shape == (M, N)
    assert _rel_l2(got.float(), want.float()) <= 0.02


@pytest.mark.parametrize("N", [24, 96])
def test_gemm_tile_unaligned_residual_and_pre(dev, N):
    """A residual or kept pre-activation that starts one element into its
    buffer (2 bytes off every wider boundary) is read and written one value
    at a time, with the same results as aligned operands."""
    rng = np.random.default_rng(24)
    M, K_ = 200, 64
    a = _rnd(rng, dev, M, K_).bfloat16()
    w = _rnd(rng, dev, N, K_, sc=K_ ** -0.5).bfloat16()
    bias = _rnd(rng, dev, N, sc=0.1)
    buf = _rnd(rng, dev, M * N + 1).bfloat16()
    res = buf[1:].view(M, N)
    got = K.gemm(a, w, bias, residual=res, epilogue="residual")
    assert torch.equal(got, K.gemm(a, w, bias, residual=res.clone(), epilogue="residual"))
    pre = torch.empty(M * N + 1, dtype=torch.bfloat16, device=dev)[1:].view(M, N)
    pre_aligned = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    got = K.gemm(a, w, bias, epilogue="gelu", pre=pre)
    assert torch.equal(got, K.gemm(a, w, bias, epilogue="gelu", pre=pre_aligned))
    assert torch.equal(pre, pre_aligned)


# One window of each length the tile is built for: L = 49 (tiny-224 stage 4),
# 56 (stages 1-2), 98 (stage 3) and 288 (base-384's 12 x 24 stripes, three
# passes over key blocks).
ATTENTION_WINDOWS = [(7, 7), (2, 28), (7, 14), (12, 24)]
ATTENTION_FORMS = ["attention", "no_softmax", "copy", "softmax", "stage", "stripe_attention",
                   "cswin_attention"]


@pytest.mark.parametrize("form", ATTENTION_FORMS)
@pytest.mark.parametrize("D", [16, 24, 32])
@pytest.mark.parametrize("window", ATTENTION_WINDOWS)
def test_attention_tile(dev, window, D, form):
    """The attention tile at every window length and head dim, in every
    mode ``window_attention`` prices and in both LePE epilogues
    (``stripe_attention``: the chain's roundings, bf16 taps;
    ``cswin_attention``: the Pallas kernel's, float32 taps), on an image
    batch of 2 x 2 windows a head and 2 heads, q, k, v as the thirds of one
    packed tensor."""
    from cswin_unet_tpu_torch.ops.attention import cswin_attention_pallas_plain

    rng = np.random.default_rng(22)
    h_sp, w_sp = window
    C = 2 * D
    packed = _rnd(rng, dev, 2, 2 * h_sp, 2 * w_sp, 3 * C).bfloat16()
    q, k, v = (packed[..., i * C:(i + 1) * C] for i in range(3))
    lw, lb = _rnd(rng, dev, C, 1, 3, 3, sc=0.3), _rnd(rng, dev, C, sc=0.1)
    scale = D ** -0.5
    if form == "stripe_attention":
        out = torch.zeros(2, 2 * h_sp, 2 * w_sp, C, dtype=torch.bfloat16, device=dev)
        kw = dict(ch_off=0, heads=2, h_sp=h_sp, w_sp=w_sp, scale=scale)
        before = K.stripe_attention.launches
        got = K.stripe_attention(packed, lw, lb, out, **kw)
        assert K.stripe_attention.launches == before + 1
        want = K.stripe_attention_plain(packed, lw, lb, torch.zeros_like(out), **kw)
    elif form == "cswin_attention":
        kw = dict(h_sp=h_sp, w_sp=w_sp, num_heads=2, scale=scale)
        got = K.cswin_attention(q, k, v, lw, lb, **kw)
        want = cswin_attention_pallas_plain(q, k, v, lw, lb, **kw)
    else:
        kw = dict(heads=2, scale=scale, h_sp=h_sp, w_sp=w_sp, mode=form)
        before = K.window_attention.launches
        got = K.window_attention(q, k, v, **kw)
        assert K.window_attention.launches == before + 1
        want = K.window_attention_plain(q, k, v, **kw)
    assert got.shape == want.shape
    assert _rel_l2(got.float(), want.float()) <= 0.02


def test_attention_tile_refuses_unaligned_operands(dev):
    """The tile copies 16-byte chunks: q, k, v off a 16-byte boundary (here
    one channel in) are refused, not read wrong."""
    rng = np.random.default_rng(23)
    packed = _rnd(rng, dev, 2, 7, 14, 3 * 64 + 1).bfloat16()
    q, k, v = (packed[..., 1 + i * 64:1 + (i + 1) * 64] for i in range(3))
    with pytest.raises(ValueError, match="16-byte"):
        K.window_attention(q, k, v, heads=2, scale=0.2, h_sp=7, w_sp=14)


def _block_params(rng, dev, C, last=False):
    cb = C if last else C // 2
    t = lambda *s, sc=0.1, off=0.0: _rnd(rng, dev, *s, sc=sc, off=off)
    lk0, lb0 = t(cb, 1, 3, 3, sc=0.3), t(cb)
    lk1, lb1 = (lk0, lb0) if last else (t(cb, 1, 3, 3, sc=0.3), t(cb))
    return BlockParams(t(C, sc=0.3, off=1.0), t(C), t(3 * C, C), t(3 * C), lk0, lb0,
                       lk1, lb1, t(C, C), t(C), t(C, sc=0.3, off=1.0), t(C),
                       t(4 * C, C), t(4 * C), t(C, 4 * C), t(C))


@pytest.mark.parametrize("H,C,heads,split,last", [
    (56, 64, 2, 1, False), (28, 128, 4, 2, False), (14, 256, 8, 7, False),
    (7, 512, 16, 7, True), (16, 32, 2, 2, False),
    # base-384 stage 3 and 4: head dim 24, 24x12 windows (L = 288, shared
    # memory above 48 KB) and the 12x12 full window
    (24, 384, 16, 12, False), (12, 768, 32, 12, True),
    # base-384 stages 1 and 2: head dim 24, 96x1 and 48x2 windows (L = 96)
    (96, 96, 4, 1, False), (48, 192, 8, 2, False)])
def test_block_chain(dev, H, C, heads, split, last):
    rng = np.random.default_rng(2)
    p = _block_params(rng, dev, C, last)
    x = _rnd(rng, dev, 2, H, H, C).bfloat16()
    kw = dict(heads=heads, split=split, last_stage=last, scale=(C // heads) ** -0.5)
    got = fused_cswin_block(x, p, **kw)
    want = composed_block(x, p, **kw)
    assert _rel_l2(got.float(), want.float()) <= 0.02


@pytest.mark.parametrize("H,C,heads,split", [(28, 128, 4, 2), (14, 256, 8, 7)])
def test_block_pair(dev, H, C, heads, split):
    """The pair kernel at the stage-2 and stage-3 geometries, B = 32: bit for
    bit against two block chains (the same device code per tile), within
    0.02 of its plain version."""
    rng = np.random.default_rng(15)
    p1, p2 = _block_params(rng, dev, C), _block_params(rng, dev, C)
    x = _rnd(rng, dev, 32, H, H, C).bfloat16()
    kw = dict(heads=heads, split=split, scale=(C // heads) ** -0.5)
    before = K.block_pair.launches
    got = K.block_pair(x, p1, p2, **kw)
    assert K.block_pair.launches == before + 1
    chain = fused_cswin_block(fused_cswin_block(x, p1, last_stage=False, **kw), p2,
                              last_stage=False, **kw)
    assert torch.equal(got, chain)
    assert _rel_l2(got.float(), K.block_pair_plain(x, p1, p2, **kw).float()) <= 0.02


def test_block_pair_refuses_float32_and_last_stage(dev):
    rng = np.random.default_rng(16)
    p = _block_params(rng, dev, 128)
    kw = dict(heads=4, split=2, scale=32 ** -0.5)
    with pytest.raises(TypeError):
        K.block_pair(_rnd(rng, dev, 2, 28, 28, 128), p, p, **kw)
    last = _block_params(rng, dev, 512, last=True)
    with pytest.raises(ValueError):
        K.block_pair(_rnd(rng, dev, 2, 7, 7, 512).bfloat16(), last, last, heads=16,
                     split=7, scale=32 ** -0.5)


ONE_STAGES = {1: (56, 64, 2, 1, False), 2: (28, 128, 4, 2, False),
              3: (14, 256, 8, 7, False), 4: (7, 512, 16, 7, True)}


@pytest.mark.parametrize("variant", list(K.BLOCK_VARIANTS))
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_block_one_variants(dev, stage, variant):
    """The one-block kernel with one part switched off, at the tiny-224
    stage geometries, B = 4, against its plain version; weights at 0.3 so
    that the switched part moves the output."""
    H, C, heads, split, last = ONE_STAGES[stage]
    rng = np.random.default_rng(30 + stage)
    p = BlockParams(*(t * 3 if t.dim() > 1 else t for t in _block_params(rng, dev, C, last)))
    x = _rnd(rng, dev, 4, H, H, C).bfloat16()
    kw = dict(heads=heads, split=split, last_stage=last, scale=(C // heads) ** -0.5)
    before = K.block_one.launches
    got = K.block_one(x, p, variant=variant, **kw)
    assert K.block_one.launches == before + 1
    assert _rel_l2(got.float(), K.block_one_plain(x, p, variant=variant, **kw).float()) <= 0.02
    if variant == "full":
        assert torch.equal(got, fused_cswin_block(x, p, **kw))


@pytest.mark.parametrize("level", range(K.CUM_LEVELS))
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_block_one_levels(dev, stage, level):
    """The build-up levels at the square dual-branch stages, B = 4."""
    H, C, heads, split, last = ONE_STAGES[stage]
    rng = np.random.default_rng(40 + stage)
    p = BlockParams(*(t * 3 if t.dim() > 1 else t for t in _block_params(rng, dev, C)))
    x = _rnd(rng, dev, 4, H, H, C).bfloat16()
    kw = dict(heads=heads, split=split, last_stage=False, scale=(C // heads) ** -0.5)
    got = K.block_one(x, p, level=level, **kw)
    assert _rel_l2(got.float(), K.block_one_plain(x, p, level=level, **kw).float()) <= 0.02


def test_block_one_refuses(dev):
    rng = np.random.default_rng(17)
    p = _block_params(rng, dev, 128)
    kw = dict(heads=4, split=2, scale=32 ** -0.5, last_stage=False)
    with pytest.raises(TypeError):
        K.block_one(_rnd(rng, dev, 2, 28, 28, 128), p, **kw)
    x = _rnd(rng, dev, 2, 28, 28, 128).bfloat16()
    with pytest.raises(ValueError):
        K.block_one(x, p, **dict(kw, heads=8))              # head dim 16
    with pytest.raises(ValueError):
        K.block_one(x, p, variant="no-lepe", level=3, **kw)  # a level of the full block
    last = _block_params(rng, dev, 512, last=True)
    with pytest.raises(ValueError):
        K.block_one(_rnd(rng, dev, 2, 7, 7, 512).bfloat16(), last, heads=16, split=7,
                    scale=32 ** -0.5, last_stage=True, level=1)


def _carafe_params(rng, dev, C, C_out, up, nc=None):
    cm = C // 4
    t = lambda *s: _rnd(rng, dev, *s, sc=0.2)
    p = [t(cm, C, 1, 1), t(cm), t(9 * up * up, cm, 3, 3), t(9 * up * up),
         t(C_out, C, 1, 1), t(C_out)]
    return p + ([t(nc, C_out, 1, 1)] if nc else [])


def _margin_mismatches(labels, ref_logits):
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    mism = labels.long() != ref_logits.argmax(-1)
    return int((mism & (margin > 0.02 * ref_logits.abs().max())).sum())


# The two CARAFE sites of tiny-224 (up@28: C 128 -> 64, x2; the tail: C 64,
# x4, 9 classes) at the serving batch and at one slice, and an H / W that
# is not a multiple of the kernel's 8x8 tile.
@pytest.mark.parametrize("B,H,W", [(32, 28, 28), (1, 28, 28), (2, 13, 10)])
def test_carafe_up(dev, B, H, W):
    rng = np.random.default_rng(3)
    p = _carafe_params(rng, dev, 128, 64, 2)
    x = _rnd(rng, dev, B, H, W, 128).bfloat16()
    got = carafe_up(x, *p)
    assert got.shape == (B, 2 * H, 2 * W, 64)
    assert _rel_l2(got.float(), carafe_up_plain(x, *p).float()) <= 0.02


@pytest.mark.parametrize("B,H,W", [(32, 56, 56), (1, 56, 56), (2, 20, 20), (2, 11, 13)])
def test_carafe_tail_logits_and_labels(dev, B, H, W):
    rng = np.random.default_rng(4)
    p = _carafe_params(rng, dev, 64, 64, 4, nc=9)
    x = _rnd(rng, dev, B, H, W, 64).bfloat16()
    want = carafe_tail_plain(x, *p).float()
    got = carafe_tail(x, *p)
    assert got.shape == (B, 4 * H, 4 * W, 9)
    assert _rel_l2(got.float(), want) <= 0.02
    labels = carafe_tail_argmax(x, *p)
    assert labels.dtype == torch.int32 and labels.shape == (B, 4 * H, 4 * W)
    assert _margin_mismatches(labels, want) == 0


# The continual heads (Synapse + KiTS23: 12 classes, + LiTS17: 14): the
# classes leave nc % 8 != 0 (the element stores) and gy stays padded to 32.
@pytest.mark.parametrize("nc", [12, 14])
@pytest.mark.parametrize("B,H,W", [(12, 56, 56), (2, 11, 13)])
def test_carafe_tail_continual_heads(dev, nc, B, H, W):
    rng = np.random.default_rng(nc)
    p = _carafe_params(rng, dev, 64, 64, 4, nc=nc)
    x = _rnd(rng, dev, B, H, W, 64).bfloat16()
    want = carafe_tail_plain(x, *p).float()
    got = carafe_tail(x, *p)
    assert got.shape == (B, 4 * H, 4 * W, nc)
    assert _rel_l2(got.float(), want) <= 0.02
    labels = carafe_tail_argmax(x, *p)
    assert labels.shape == (B, 4 * H, 4 * W)
    assert _margin_mismatches(labels, want) == 0


# base-384's two fused sites: upsample2 (48 -> 96, C 192 -> 96: c_mid 48,
# nc 96, gy 144 channels) and the x4 tail at C 96 (c_mid 24, padded to 32 in
# the encoder's products; gy 24 + 9 -> 40 channels), logits and labels. The
# labels are held to the plain composition in float32: the bf16 one rounds
# the encoder's output to bf16 before the softmax, which the kernel keeps in
# float32, and at this width that moves one of the 4.7M tail pixels (B = 32)
# by 0.45 in a logit, 2.1% of the largest |logit|, where the kernel stays
# within 0.02 of the float64 composition.
@pytest.mark.parametrize("B", [32, 2])
def test_carafe_base384_sites(dev, B):
    rng = np.random.default_rng(30 + B)
    p = _carafe_params(rng, dev, 192, 96, 2)
    x = _rnd(rng, dev, B, 48, 48, 192).bfloat16()
    got = carafe_up(x, *p)
    assert got.shape == (B, 96, 96, 96)
    assert _rel_l2(got.float(), carafe_up_plain(x, *p).float()) <= 0.02
    p = _carafe_params(rng, dev, 96, 96, 4, nc=9)
    x = _rnd(rng, dev, B, 96, 96, 96).bfloat16()
    want = carafe_tail_plain(x, *p).float()
    got = carafe_tail(x, *p)
    assert got.shape == (B, 384, 384, 9)
    assert _rel_l2(got.float(), want) <= 0.02
    labels = carafe_tail_argmax(x, *p)
    assert labels.dtype == torch.int32 and labels.shape == (B, 384, 384)
    assert _margin_mismatches(labels, carafe_tail_plain(x.float(), *p)) == 0


def test_carafe_base384_fn_grads(dev):
    """``CarafeFn`` at both base-384 sites: the kernel forward and the
    composition's vjp against autograd of the composition."""
    rng = np.random.default_rng(33)
    for fn, plain, C, C_out, up, nc, H in (
            (carafe_up, carafe_up_plain, 192, 96, 2, None, 48),
            (carafe_tail, carafe_tail_plain, 96, 96, 4, 9, 96)):
        p = _carafe_params(rng, dev, C, C_out, up, nc)
        x = _rnd(rng, dev, 2, H, H, C).bfloat16()
        g = _rnd(rng, dev, 2, up * H, up * H, nc or C_out).bfloat16()
        res = []
        for f in (fn, plain):
            leaves = [x.clone().requires_grad_()] + [q.clone().requires_grad_() for q in p]
            out = f(*leaves)
            res.append([out] + list(torch.autograd.grad(out, leaves, g)))
        for i, (a, b) in enumerate(zip(*res)):
            assert _rel_l2(a.float(), b.float()) <= 0.02, i


@pytest.mark.parametrize("n", [384, 224])
def test_augment_on_the_card_matches_the_cpu(dev, n):
    """``ops.augment`` on CUDA tensors equals the same ops on the CPU bit for
    bit at one set of draws (every branch present), and a CUDA generator's
    draws stay on the card."""
    from cswin_unet_tpu_torch.ops import augment as A

    rng = np.random.default_rng(34)
    img = torch.from_numpy(rng.standard_normal((24, n, n, 1)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 9, (24, n, n)).astype(np.int64))
    d = A.draw(24, torch.Generator().manual_seed(4), torch.device("cpu"))
    flip, rotate = A.branches(d)
    assert flip.any() and rotate.any() and (~flip & ~rotate).any()
    want = A.apply_draws(img, lab, d)
    got = A.apply_draws(img.to(dev), lab.to(dev), {k: v.to(dev) for k, v in d.items()})
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    out = A.augment_batch(img.to(dev), lab.to(dev), torch.Generator(device=dev).manual_seed(0))
    assert out[0].device.type == "cuda" and out[0].shape == img.shape


def test_carafe_reassemble_ignores_padding_channels(dev):
    """The GEMM's padding channels of gy reach no output: NaN there changes
    nothing. A gy whose channels are not a multiple of 8 is refused."""
    rng = np.random.default_rng(11)
    cm, nc = 16, 9
    gy = _rnd(rng, dev, 2, 12, 20, 32).bfloat16()
    gy[..., cm + nc:] = 0
    ew, eb, bo = _rnd(rng, dev, 144, cm, 3, 3, sc=0.2), _rnd(rng, dev, 144), _rnd(rng, dev, nc)
    for labels in (False, True):
        kw = dict(c_mid=cm, up=4, labels=labels)
        want = K.carafe_reassemble(gy, ew, eb, bo, **kw)
        nan = gy.clone()
        nan[..., cm + nc:] = float("nan")
        assert torch.equal(K.carafe_reassemble(nan, ew, eb, bo, **kw), want)
        with pytest.raises(ValueError):
            K.carafe_reassemble(gy[..., :cm + nc].contiguous(), ew, eb, bo, **kw)


def _device_kernels(fn) -> list[str]:
    """Names of the device kernels one call of ``fn`` runs (after a warm-up
    call), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


# The train path's shapes (stage 1 and 2 at bs 24), every width base-384
# needs, C = 512, and row counts that leave CTAs short: 1, 63, 65 and fewer
# rows than one wave of CTAs.
@pytest.mark.parametrize("M,C", [(75264, 64), (18816, 128), (1000, 96), (1000, 192),
                                 (1000, 384), (333, 512), (1, 64), (63, 64), (65, 128),
                                 (1, 512), (63, 96), (65, 384), (200, 512), (75, 256)])
def test_layernorm_bwd(dev, M, C):
    rng = np.random.default_rng(5)
    x, dy, res = (_rnd(rng, dev, M, C).bfloat16() for _ in range(3))
    w = _rnd(rng, dev, C, sc=0.3, off=1.0)
    plan = K._layernorm_bwd_plan(x.device, M, C)
    assert plan.grid <= -(-M // plan.rows_per_step)
    for r in (res, None):
        before = K.layernorm_bwd.launches
        got = K.layernorm_bwd(x, dy, w, residual=r)
        assert K.layernorm_bwd.launches == before + 1
        again = K.layernorm_bwd(x, dy, w, residual=r)
        for g, want, g2 in zip(got, K.layernorm_bwd_plain(x, dy, w, residual=r), again):
            assert _rel_l2(g.float(), want.float()) <= 0.02
            assert torch.equal(g, g2)  # deterministic: the same bits twice


def test_layernorm_bwd_is_one_launch(dev):
    rng = np.random.default_rng(12)
    x, dy, res = (_rnd(rng, dev, 18816, 128).bfloat16() for _ in range(3))
    w = _rnd(rng, dev, 128, sc=0.3, off=1.0)
    names = _device_kernels(lambda: K.layernorm_bwd(x, dy, w, residual=res))
    assert len(names) == 1 and "layernorm_bwd_kernel" in names[0], names


@pytest.mark.parametrize("M,N,K_,hw", [(200, 96, 64, 50), (130, 24, 64, 65),
                                       (64, 512, 2048, 16)])
def test_gemm_dgrad_and_wgrad(dev, M, N, K_, hw):
    rng = np.random.default_rng(6)
    dy, x = _rnd(rng, dev, M, N).bfloat16(), _rnd(rng, dev, M, K_).bfloat16()
    w = _rnd(rng, dev, N, K_, sc=N ** -0.5)
    h = _rnd(rng, dev, M, K_).bfloat16()
    dp = torch.from_numpy((rng.random(M // hw) < 0.7).astype(np.float32) / 0.7).to(dev)
    for kw in ({}, dict(dp=dp, rows_per_sample=hw),
               dict(dp=dp, rows_per_sample=hw, gelu_h=h)):
        got, want = K.gemm_dgrad(dy, w, **kw), K.gemm_dgrad_plain(dy, w, **kw)
        assert _rel_l2(got.float(), want.float()) <= 0.02, kw
    for kw in ({}, dict(dp=dp, rows_per_sample=hw)):
        got, want = K.gemm_wgrad(x, dy, **kw), K.gemm_wgrad_plain(x, dy, **kw)
        for g, ww in zip(got, want):
            assert g.dtype == torch.float32
            assert _rel_l2(g, ww) <= 0.02, kw


def test_gemm_training_epilogues(dev):
    rng = np.random.default_rng(7)
    M, N, K_, hw = 300, 128, 64, 100
    a, res = _rnd(rng, dev, M, K_).bfloat16(), _rnd(rng, dev, M, N).bfloat16()
    w, bias = _rnd(rng, dev, N, K_, sc=K_ ** -0.5).bfloat16(), _rnd(rng, dev, N, sc=0.1)
    dp = torch.tensor([0.0, 1.25, 1.25], device=dev)
    got = K.gemm(a, w, bias, residual=res, epilogue="residual", dp=dp,
                 rows_per_sample=hw)
    want = K.gemm_plain(a, w, bias, residual=res, epilogue="residual", dp=dp,
                        rows_per_sample=hw)
    assert _rel_l2(got.float(), want.float()) <= 0.02
    assert torch.equal(got[:hw], res[:hw])  # a dropped sample keeps its residual
    pre_k, pre_p = (torch.empty(M, N, dtype=torch.bfloat16, device=dev) for _ in range(2))
    got = K.gemm(a, w, bias, epilogue="gelu", pre=pre_k)
    want = K.gemm_plain(a, w, bias, epilogue="gelu", pre=pre_p)
    assert _rel_l2(got.float(), want.float()) <= 0.02
    assert _rel_l2(pre_k.float(), pre_p.float()) <= 0.02


@pytest.mark.parametrize("H,C,heads,split,last", [
    (56, 64, 2, 1, False), (28, 128, 4, 2, False), (14, 256, 8, 7, False),
    (7, 512, 16, 7, True), (16, 48, 2, 4, False),
    (96, 96, 4, 1, False), (48, 192, 8, 2, False)])  # base-384 stages 1-2: L = 96, d = 24
def test_stripe_attention_bwd(dev, H, C, heads, split, last):
    rng = np.random.default_rng(8)
    qkv = _rnd(rng, dev, 2, H, H, 3 * C).bfloat16()
    dout = _rnd(rng, dev, 2, H, H, C).bfloat16()
    branches = ([(0, C, heads, H, H)] if last else
                [(0, C // 2, heads // 2, H, split), (C // 2, C // 2, heads // 2, split, H)])
    for off, cb, nh, hs, ws in branches:
        lw = _rnd(rng, dev, cb, 1, 3, 3, sc=0.3)
        kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=(C // heads) ** -0.5)
        chans = torch.cat([torch.arange(off, off + cb) + i * C for i in range(3)]).to(dev)
        outs = []
        for fn in (K.stripe_attention_bwd, K.stripe_attention_bwd_plain):
            dqkv = torch.zeros(2, H, H, 3 * C, dtype=torch.bfloat16, device=dev)
            dw, db = fn(qkv, dout, lw, dqkv, **kw)
            outs.append((dqkv[..., chans], dw, db))
        for g, want in zip(*outs):
            assert _rel_l2(g.float(), want.float()) <= 0.02


@pytest.mark.parametrize("H,C,heads,split", [(56, 64, 2, 1), (28, 128, 4, 2),
                                             (14, 256, 8, 7),
                                             # base-384's two stages that train through it
                                             (96, 96, 4, 1), (48, 192, 8, 2)])
def test_block_fn_grads(dev, H, C, heads, split):
    rng = np.random.default_rng(9)
    t = lambda *s, sc=0.1, off=0.0: _rnd(rng, dev, *s, sc=sc, off=off)
    p = [t(C, sc=0.3, off=1.0), t(C), t(3 * C, C), t(3 * C), t(C // 2, 1, 3, 3, sc=0.3),
         t(C // 2), t(C // 2, 1, 3, 3, sc=0.3), t(C // 2), t(C, C), t(C),
         t(C, sc=0.3, off=1.0), t(C), t(4 * C, C), t(4 * C), t(C, 4 * C), t(C)]
    x, g = _rnd(rng, dev, 4, H, H, C).bfloat16(), _rnd(rng, dev, 4, H, H, C).bfloat16()
    dps = (torch.tensor([0.0, 1.25, 1.25, 1.25], device=dev),
           torch.tensor([1.25, 1.25, 0.0, 1.25], device=dev))
    kw = dict(heads=heads, split=split, last_stage=False, scale=(C // heads) ** -0.5,
              dps=dps)
    res = []
    for fn in (fused_cswin_block, composed_block):
        leaves = [x.clone().requires_grad_()] + [q.clone().requires_grad_() for q in p]
        out = fn(leaves[0], BlockParams(*leaves[1:]), **kw)
        res.append([out] + list(torch.autograd.grad(out, leaves, g)))
    for i, (a, b) in enumerate(zip(*res)):
        assert _rel_l2(a.float(), b.float()) <= 0.02, i


def test_carafe_fn_grads(dev):
    rng = np.random.default_rng(10)
    for fn, plain, C, up, nc, H in ((carafe_up, carafe_up_plain, 128, 2, None, 28),
                                    (carafe_tail, carafe_tail_plain, 64, 4, 9, 20)):
        p = _carafe_params(rng, dev, C, 64, up, nc)
        x = _rnd(rng, dev, 2, H, H, C).bfloat16()
        g = _rnd(rng, dev, 2, up * H, up * H, nc or 64).bfloat16()
        res = []
        for f in (fn, plain):
            leaves = [x.clone().requires_grad_()] + [q.clone().requires_grad_() for q in p]
            out = f(*leaves)
            res.append([out] + list(torch.autograd.grad(out, leaves, g)))
        for i, (a, b) in enumerate(zip(*res)):
            assert _rel_l2(a.float(), b.float()) <= 0.02, i


def test_kernel_wrappers_refuse_float32_on_gpu(dev):
    x = torch.zeros(4, 64, device=dev)
    with pytest.raises(TypeError):
        K.layernorm(x, torch.ones(64, device=dev), torch.zeros(64, device=dev))


@pytest.mark.parametrize("shape", [(6, 24, 24), (5, 17, 33), (3, 40, 512), (48, 64, 70)])
def test_edt_pass_bit_for_bit(dev, shape):
    """Every axis, including lines whose inner stride is not a multiple of
    the kernel's 32-line tile; seeds, partial sums and +inf (1e12)."""
    rng = np.random.default_rng(11)
    f = np.where(rng.random(shape) < 0.1, 0.0, 1e12).astype(np.float32)
    part = rng.random(shape) < 0.1
    f[part] = rng.uniform(0, 300, part.sum())
    ft = torch.from_numpy(f).to(dev)
    for ax in range(3):
        before = K.edt_pass.launches
        got = K.edt_pass(ft, ax)
        assert K.edt_pass.launches == before + 1
        assert torch.equal(got, K.edt_pass_plain(ft, ax))


def _edt_lines(case: str, L: int, rng) -> np.ndarray:
    """(n, L) lines where the envelope's exactness is at stake."""
    n, inf = 40, np.float32(1e12)
    f = np.full((n, L), inf, np.float32)
    if case == "ties":  # equal seeds an even distance apart: exact ties midway
        for r in range(n):
            f[r, r % 5::2 * (r % 7 + 1)] = 0.0
            f[r, (r * 13) % L] = np.float32(4 * (r % 3))
    elif case == "large":  # integers near 1e12 (float32: multiples of 65536)
        f = (inf - np.float32(65536) * rng.integers(0, 300, (n, L))).astype(np.float32)
        f[::3, rng.integers(0, L)] = 0.0
    elif case == "mixed":  # 1e12 beside small and non-integer finite values
        part = rng.random((n, L)) < 0.05
        f[part] = rng.uniform(0, 5, part.sum()).astype(np.float32)
        f[1::4, -1] = np.float32(1e-3)
    elif case == "one_value":  # lines of one value come back as they are
        f = np.repeat(np.array([0.0, -0.0, 3.5, 1e12, np.inf, -np.inf, 7.0, 2.0],
                               np.float32), n // 8)[:, None].repeat(L, 1)
        f[n - 1, 0] = np.nan
    elif case == "non_finite":  # +inf skipped; a NaN or -inf takes the line
        f[rng.random((n, L)) < 0.02] = 0.0
        f[0::5, rng.integers(0, L)] = np.inf
        f[1::5] = np.inf
        f[2::5, 0] = np.nan
        f[3::5, L - 1] = -np.inf
    return f


@pytest.mark.parametrize("case", ["ties", "all_inf", "large", "mixed", "one_value",
                                  "non_finite"])
@pytest.mark.parametrize("L", [1, 2, 48, 512, 1760, 2048])
def test_edt_pass_edge_lines(dev, case, L):
    """Bit for bit along the contiguous axis, along columns and along a
    middle axis, on lines of 1 to 2048 (the longest the wrapper takes)."""
    f = torch.from_numpy(_edt_lines(case, L, np.random.default_rng(L))).to(dev)
    for t, ax in ((f, 1), (f.t().contiguous(), 0), (f.view(2, 20, L).transpose(1, 2)
                                                    .contiguous(), 1)):
        before = K.edt_pass.launches
        got = K.edt_pass(t, ax)
        assert K.edt_pass.launches == before + 1
        torch.testing.assert_close(got, K.edt_pass_plain(t, ax), rtol=0, atol=0,
                                   equal_nan=True)


def test_edt_pass_refuses_longer_lines(dev):
    with pytest.raises(ValueError, match="exceeds 2048"):
        K.edt_pass(torch.zeros(2, 2049, device=dev), 1)


@pytest.mark.parametrize("L", [1, 2, 48, 64, 65, 170, 512, 1000, 1760, 2048, 4096, 65536])
def test_edt_pass_plan_matches_the_kernel(dev, L):
    from cswin_unet_tpu_torch.ops.cuda.build import library

    for last in (True, False):
        assert library().cswin_edt_pass_lines(L, int(last)) == K.edt_pass_plan(L, last).lines


@pytest.mark.parametrize("H,C,heads,split,last", [
    (56, 64, 2, 1, False), (28, 128, 4, 2, False), (14, 256, 8, 7, False),
    (7, 512, 16, 7, True)])
def test_cswin_attention_kernel(dev, H, C, heads, split, last):
    """The pallas route's kernel on q, k, v slices of one qkv tensor (no
    copy), float32 LePE, against the Pallas rounding's plain version."""
    from cswin_unet_tpu_torch.ops.attention import cswin_attention_pallas_plain

    rng = np.random.default_rng(12)
    qkv = _rnd(rng, dev, 2, H, H, 3, C).bfloat16()
    branches = ([(0, C, heads, H, H)] if last else
                [(0, C // 2, heads // 2, H, split), (C // 2, C // 2, heads // 2, split, H)])
    for off, cb, nh, hs, ws in branches:
        q, k, v = (qkv[..., i, off:off + cb] for i in range(3))
        lw, lb = _rnd(rng, dev, cb, 1, 3, 3, sc=0.3), _rnd(rng, dev, cb, sc=0.1)
        kw = dict(h_sp=hs, w_sp=ws, num_heads=nh, scale=(C // heads) ** -0.5)
        before = K.cswin_attention.launches
        got = K.cswin_attention(q, k, v, lw, lb, **kw)
        assert K.cswin_attention.launches == before + 1
        want = cswin_attention_pallas_plain(q, k, v, lw, lb, **kw)
        assert got.is_contiguous() and got.shape == want.shape
        assert _rel_l2(got.float(), want.float()) <= 0.02
    with pytest.raises(ValueError):  # q, k, v must share one pixel stride
        K.cswin_attention(q, k.contiguous(), v, lw, lb, **kw)


def test_cswin_attention_fn_grads(dev):
    from cswin_unet_tpu_torch.ops.attention import (cswin_attention,
                                                    cswin_attention_pallas_plain)

    rng = np.random.default_rng(13)
    kw = dict(h_sp=14, w_sp=7, num_heads=4, scale=32 ** -0.5)
    inputs = [_rnd(rng, dev, 4, 14, 14, 128).bfloat16() for _ in range(3)]
    inputs += [_rnd(rng, dev, 128, 1, 3, 3, sc=0.3), _rnd(rng, dev, 128, sc=0.1)]
    g = _rnd(rng, dev, 4, 14, 14, 128).bfloat16()
    res = []
    for fn in (lambda *t: cswin_attention(*t, impl="pallas", **kw),
               lambda *t: cswin_attention_pallas_plain(*t, **kw)):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        res.append([out] + list(torch.autograd.grad(out, leaves, g)))
    for i, (a, b) in enumerate(zip(*res)):
        assert _rel_l2(a.float(), b.float()) <= 0.02, i


def test_volume_metrics_device_on_the_card(dev):
    from scipy import ndimage

    from cswin_unet_tpu_torch.metrics import volume_metrics
    from cswin_unet_tpu_torch.ops.edt import volume_metrics_device

    rng = np.random.default_rng(14)
    label = np.zeros((10, 96, 96), np.int32)
    for c in (1, 2, 3):
        x = ndimage.gaussian_filter(rng.standard_normal(label.shape), 2.0)
        label[x > np.quantile(x, 0.9)] = c
    pred = label.copy()
    pred[rng.random(pred.shape) < 0.02] = 2
    pred[2:4, :5, :5] = 4          # pred only -> (1, 0); class 5: empty -> (0, 0)
    before = K.edt_pass.launches
    got = volume_metrics_device(torch.from_numpy(pred).to(dev),
                                torch.from_numpy(label).to(dev), 6)
    assert got.device.type == "cuda" and K.edt_pass.launches == before + 5 * 2 * 3
    np.testing.assert_allclose(got.cpu().numpy(), np.array(volume_metrics(pred, label, 6)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sp_h,sp_w,c", [(7, 14, 128), (2, 28, 64), (1, 56, 32), (7, 7, 512)])
def test_lepe_windows(dev, sp_h, sp_w, c):
    """LePE alone at the four branch geometries: windows and image layout,
    transposed taps, V in place from packed qkv, two tap sets, two sources
    stacked on channels with the fold, bf16 taps."""
    rng = np.random.default_rng(17)
    n, L = 6, sp_h * sp_w
    qkv = _rnd(rng, dev, n, L, 3 * c).bfloat16()
    v = qkv[..., 2 * c:]
    taps, bias = _rnd(rng, dev, 3, 3, c, sc=0.3), _rnd(rng, dev, c, sc=0.1)
    taps2, bias2 = _rnd(rng, dev, 3, 3, c, sc=0.3), _rnd(rng, dev, c, sc=0.1)
    geo = dict(sp_h=sp_h, sp_w=sp_w)
    img = _rnd(rng, dev, 2, 2 * sp_h, 3 * sp_w, c).bfloat16()
    wide = torch.cat([taps, taps2], -1)
    cases = [(v.contiguous(), taps, bias, {}), (v, taps, bias, dict(swap=True)),
             (img, taps, None, {}), (v, taps, bias, dict(taps2=taps2, bias2=bias2, n0=4)),
             (v, taps, bias, dict(tap_dtype=torch.bfloat16)),
             (v, wide, None, dict(v2=qkv[..., :c])),
             (v, wide, None, dict(v2=qkv[..., :c], fold=True))]
    for src, t, b, kw in cases:
        before = K.lepe_windows.launches
        got = K.lepe_windows(src, t, b, **geo, **kw)
        assert K.lepe_windows.launches == before + 1
        want = K.lepe_windows_plain(src, t, b, **geo, **kw)
        assert got.shape == want.shape and got.is_contiguous(), kw
        assert _rel_l2(got.float(), want.float()) <= 0.02, kw
    with pytest.raises(TypeError):
        K.lepe_windows(v.float(), taps, bias, **geo)


@pytest.mark.parametrize("mode", ["attention", "no_softmax", "copy", "softmax", "stage"])
@pytest.mark.parametrize("shape,heads,window", [
    ((3, 56, 56, 32), 1, (1, 56)), ((3, 56, 56, 32), 1, (56, 1)),
    ((3, 14, 14, 128), 4, (7, 14)), ((8, 98, 128), 4, None), ((5, 49, 96), 4, None)])
def test_window_attention(dev, mode, shape, heads, window):
    """Attention alone on rows, columns and 7x14 windows of an image batch
    and on stacked windows (head dims 32 and 24), q, k, v as slices of one
    packed tensor, in each mode."""
    rng = np.random.default_rng(18)
    C = shape[-1]
    packed = _rnd(rng, dev, *shape[:-1], 3 * C).bfloat16()
    q, k, v = (packed[..., i * C:(i + 1) * C] for i in range(3))
    kw = dict(heads=heads, scale=(C // heads) ** -0.5, mode=mode)
    if window is not None:
        kw.update(h_sp=window[0], w_sp=window[1])
    before = K.window_attention.launches
    got = K.window_attention(q, k, v, **kw)
    assert K.window_attention.launches == before + 1
    want = K.window_attention_plain(q, k, v, **kw)
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel_l2(got.float(), want.float()) <= 0.02
    with pytest.raises(ValueError):  # q, k, v must share one pixel stride
        K.window_attention(q, k.contiguous(), v, **kw)


@pytest.mark.parametrize("act,ln,fold", [("gelu", True, False), ("clamp", True, False),
                                         ("gelu", False, False), ("gelu", False, True),
                                         ("clamp", True, True)])
@pytest.mark.parametrize("rows", [64 * 7, 1000])
def test_ln_mlp(dev, act, ln, fold, rows):
    """The one-launch MLP half at C = 64 in each mode, on a row count that
    fills its 64-row tiles and on one that does not; against its plain
    version and, in the block's own mode, against the chain's three
    launches."""
    rng = np.random.default_rng(19)
    C = 64
    x = _rnd(rng, dev, rows, C).bfloat16()
    nw, nb = _rnd(rng, dev, C, sc=0.3, off=1.0), _rnd(rng, dev, C, sc=0.1)
    w1 = _rnd(rng, dev, 4 * C, C, sc=C ** -0.5).bfloat16()
    w2 = _rnd(rng, dev, C, 4 * C, sc=(4 * C) ** -0.5).bfloat16()
    b1, b2 = _rnd(rng, dev, 4 * C, sc=0.1), _rnd(rng, dev, C, sc=0.1)
    args = (nw, nb, w1, b1) + (() if fold else (w2, b2))
    kw = dict(act=act, ln=ln, fold=fold)
    before = K.ln_mlp.launches
    got = K.ln_mlp(x, *args, **kw)
    assert K.ln_mlp.launches == before + 1
    assert _rel_l2(got.float(), K.ln_mlp_plain(x, *args, **kw).float()) <= 0.02
    if (act, ln, fold) == ("gelu", True, False):
        h = K.gemm(K.layernorm(x, nw, nb), w1, b1, epilogue="gelu")
        chain = K.gemm(h, w2, b2, residual=x, epilogue="residual")
        assert _rel_l2(got.float(), chain.float()) <= 5e-3


def test_ln_mlp_refuses_other_widths(dev):
    x = torch.zeros(8, 128, dtype=torch.bfloat16, device=dev)
    w1 = torch.zeros(512, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        K.ln_mlp(x, None, None, w1, None, ln=False, fold=True)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_parts_add_up_to_stripe_attention(dev, stage):
    """``window_attention`` + ``lepe_windows`` on the thirds of one packed
    qkv against ``stripe_attention`` on it, both branches of the stage,
    within 2 bf16 ulps of the output's scale."""
    from cswin_unet_tpu_torch.tools import block_lab

    g = block_lab.STAGES[stage]
    H, W, C, split = g["H"], g["W"], g["C"], g["split"]
    rng = np.random.default_rng(20)
    qkv = _rnd(rng, dev, 4, H, W, 3 * C).bfloat16()
    for off, (sp_h, sp_w) in ((0, (H, split)), (C // 2, (split, W))):
        taps, bias = _rnd(rng, dev, 3, 3, C // 2, sc=0.3), _rnd(rng, dev, C // 2, sc=0.1)
        att, lepe, whole = block_lab.parts_vs_whole(
            qkv, taps, bias, sp_h=sp_h, sp_w=sp_w, heads=g["heads"] // 2,
            scale=(C // g["heads"]) ** -0.5, ch_off=off)
        block_lab.check_parts_vs_whole(att, lepe, whole)


# The weight gradient at the train shapes of stages 1 and 2 (bs 24: M =
# 24·56², 24·28²) and at an odd M, with and without the drop-path scale:
# within 0.02 of its plain version, and the same bits from two calls (the
# kernel adds its splits in a fixed order).
WGRAD_SHAPES = [(24 * 56 * 56, 56 * 56, C, n, k) for C in (64,)
                for n, k in ((C, 4 * C), (4 * C, C), (C, C), (3 * C, C))]
WGRAD_SHAPES += [(24 * 28 * 28, 28 * 28, C, n, k) for C in (128,)
                 for n, k in ((C, 4 * C), (4 * C, C), (C, C), (3 * C, C))]
WGRAD_SHAPES += [(1001, 77, 0, 96, 64), (4099, 4099, 0, 40, 136)]


@pytest.mark.parametrize("droppath", [False, True])
@pytest.mark.parametrize("M,hw,C,N,K_", WGRAD_SHAPES)
def test_gemm_wgrad_train_shapes(dev, M, hw, C, N, K_, droppath):
    rng = np.random.default_rng(21)
    x, dy = _rnd(rng, dev, M, K_).bfloat16(), _rnd(rng, dev, M, N).bfloat16()
    kw = {}
    if droppath:
        dp = (rng.random(M // hw) < 0.8).astype(np.float32) / 0.8
        kw = dict(dp=torch.from_numpy(dp).to(dev), rows_per_sample=hw)
    before = K.gemm_wgrad.launches
    got, again = K.gemm_wgrad(x, dy, **kw), K.gemm_wgrad(x, dy, **kw)
    assert K.gemm_wgrad.launches == before + 2
    for g, a, want in zip(got, again, K.gemm_wgrad_plain(x, dy, **kw)):
        assert g.dtype == torch.float32 and g.shape == want.shape
        assert _rel_l2(g, want) <= 0.02
        assert torch.equal(g, a)
    plan = K.wgrad_plan(M, N, K_)
    if C:
        assert plan.partial_bytes <= 0.25 * (x.numel() + dy.numel()) * 2


# The attention backward at L = 49, 56, 98 and at base-384's 288-token
# windows (24x12 and 12x24, d = 24, stage 3's width): within 0.02 of its
# plain version, the same bits from two calls.
ATTENTION_BWD_CASES = [
    # (B, H, W, C, heads of the branch, h_sp, w_sp, ch_off)
    (2, 14, 14, 128, 2, 7, 7, 64),      # L = 49
    (4, 56, 56, 64, 1, 56, 1, 0),       # L = 56, stage 1 vertical
    (4, 56, 56, 64, 1, 1, 56, 32),      # stage 1 horizontal
    (4, 28, 28, 128, 2, 28, 2, 0),      # stage 2
    (4, 14, 14, 256, 4, 14, 7, 128),    # L = 98, stage 3
    (2, 24, 24, 384, 8, 24, 12, 0),     # base-384 stage 3, L = 288, d = 24
    (2, 24, 24, 384, 8, 12, 24, 192),
    (1, 24, 24, 512, 8, 12, 24, 256),   # L = 288 at d = 32
    (2, 96, 96, 96, 2, 96, 1, 0),       # base-384 stage 1, L = 96, d = 24
    (2, 48, 48, 192, 4, 2, 48, 96),     # base-384 stage 2 horizontal
]


@pytest.mark.parametrize("B,H,W,C,nh,hs,ws,off", ATTENTION_BWD_CASES)
def test_stripe_attention_bwd_windows(dev, B, H, W, C, nh, hs, ws, off):
    rng = np.random.default_rng(22)
    cb = C // 2
    qkv = _rnd(rng, dev, B, H, W, 3 * C).bfloat16()
    dout = _rnd(rng, dev, B, H, W, C).bfloat16()
    lw = _rnd(rng, dev, cb, 1, 3, 3, sc=0.3)
    kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=(cb // nh) ** -0.5)
    chans = torch.cat([torch.arange(off, off + cb) + i * C for i in range(3)]).to(dev)

    def run(fn):
        dqkv = torch.zeros(B, H, W, 3 * C, dtype=torch.bfloat16, device=dev)
        dw, db = fn(qkv, dout, lw, dqkv, **kw)
        return dqkv[..., chans], dw, db

    before = K.stripe_attention_bwd.launches
    got, again = run(K.stripe_attention_bwd), run(K.stripe_attention_bwd)
    assert K.stripe_attention_bwd.launches == before + 2
    for g, a, want in zip(got, again, run(K.stripe_attention_bwd_plain)):
        assert _rel_l2(g.float(), want.float()) <= 0.02
        assert torch.equal(g, a)


@pytest.mark.parametrize("L", [49, 56, 64, 65, 98, 288, 304])
@pytest.mark.parametrize("d", [16, 24, 32])
def test_stripe_attention_bwd_smem_matches_the_kernel(dev, L, d):
    from cswin_unet_tpu_torch.ops.cuda.build import library

    assert library().cswin_stripe_attention_bwd_smem(L, d) == K.stripe_attention_bwd_smem(L, d)


# ---- data parallelism on the card ----------------------------------------

GPU_DP = dict(img_size=128, embed_dim=64, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2),
              num_heads=(2, 4, 8, 16), num_classes=4)  # head dim 16 / 32: compiled


def _dp_model(train: bool):
    from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet

    torch.manual_seed(0)
    model = CSwinUnet(CSWinUNet(drop_path_rate=0.2 if train else 0.0, **GPU_DP)).cuda()
    return model.train(train)


def _dp_batch():
    rng = np.random.default_rng(31)
    return (torch.from_numpy(rng.standard_normal((8, 128, 128, 1)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 4, (8, 128, 128)).astype(np.int64)))


def _dp_steps(rank):
    """Two steps (drop-path and ``device_augment`` live) of ``rank``'s rows
    of the batch, in DDP under a process group; (losses, parameters)."""
    from cswin_unet_tpu_torch.parallel import all_reduce_mean_, wrap_ddp
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step

    img, lab = _dp_batch()
    if rank is not None:
        img, lab = img[rank * 4:(rank + 1) * 4], lab[rank * 4:(rank + 1) * 4]
    model = _dp_model(True)
    opt, sched = make_optimizer(model.parameters(), 0.05, 100)
    dev = torch.device("cuda", 0)
    step = make_train_step(wrap_ddp(model, dev), opt, sched, 4, device_augment=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    losses = [float(all_reduce_mean_([step(img.to(dev), lab.to(dev), gen)["loss"]])[0])
              for _ in range(2)]
    return losses, {k: v.detach().float().cpu() for k, v in model.named_parameters()}


def _dp_rank(rank, port, out):
    from datetime import timedelta

    from cswin_unet_tpu_torch.parallel import destroy_distributed, init_distributed

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK="0")
    init_distributed("cuda", backend="gloo", timeout=timedelta(seconds=60))
    try:
        torch.save(_dp_steps(rank), os.path.join(out, f"rank{rank}.pt"))
    finally:
        destroy_distributed()


def test_two_gloo_ranks_on_the_card_equal_one_process(dev, tmp_path):
    """Two gloo ranks on the one card, 4 rows each, against one process on
    the 8 rows: losses and every parameter within relative L2 0.02 (bf16
    kernels; only the order of the sums differs)."""
    import multiprocessing as mp
    import socket
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, port, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    left = [p for p in procs if p.is_alive()]
    for p in left:
        p.kill()
        p.join(10)
    assert not left and [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    want_losses, want = _dp_steps(None)
    before = {k: v.detach().float().cpu() for k, v in _dp_model(True).named_parameters()}
    for losses, params in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=0.02)
        for k in want:
            assert _rel_l2(params[k] - before[k], want[k] - before[k]) <= 0.02, k


def test_split_inferencer_on_one_card(dev):
    """``VolumeInferencer(devices=[cuda:0, cuda:0])``: two replicas, each
    part under its device; the labels of 11 slices equal one device's and
    every kernel launches twice as often."""
    from cswin_unet_tpu_torch.eval.inference import VolumeInferencer

    model = _dp_model(False)
    x = np.random.default_rng(32).standard_normal((11, 128, 128)).astype(np.float32)
    got = []
    for devices in (None, [dev, dev]):
        inf = VolumeInferencer(model, device=dev, patch_size=(128, 128), batch_slices=8,
                               devices=devices)
        K.reset_launch_counts()
        got.append((inf.predict_slices(x), K.launch_counts()))
    (one, c1), (two, c2) = got
    np.testing.assert_array_equal(two, one)
    assert any(c1.values()) and all(c2[k] == 2 * c1[k] for k in c1)


def test_kernel_refuses_a_tensor_off_the_current_device(dev, monkeypatch):
    """The kernels launch on the current device: a tensor on another one is
    refused with both devices named, before any launch."""
    x = torch.zeros(4, 64, device=dev, dtype=torch.bfloat16)
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    before = K.layernorm.launches
    # torch's own binding stands in for a second card, which a one-card host lacks
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: x.device.index + 1)
    with pytest.raises(ValueError, match=rf"cuda:{x.device.index}.*cuda:{x.device.index + 1}"):
        K.layernorm(x, w, b)
    assert K.layernorm.launches == before
