"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: these skip on a machine without an NVIDIA GPU (a CUDA
kernel has no CPU mode; the CPU tests cover each kernel's plain version
against the JAX package). On the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which this file does
not need.)

Tolerance: relative L2 error <= 0.02 in bf16 (the reference gate's
default); labels by the margin rule (a mismatch counts only where the plain
top-2 logit gap exceeds 0.02·max|logit|). The float32 instances
(``-k f32``) are held to their plain float32 versions at relative L2
<= 1e-5 (the same arithmetic in another sum order), the whole float32
model to its plain route at 1e-4, and the float32 pair to two float32
chains bit for bit; both TF32 flags are off (the ``dev`` fixture).
"""

import itertools
import os

import numpy as np
import pytest
import torch

from cswin_unet_tpu_torch.ops import dropout as D
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
    with pytest.raises(TypeError):  # float16 has no instance (float32 has, since the
        K.block_pair(_rnd(rng, dev, 2, 28, 28, 128).half(), p, p, **kw)  # float32 slice)
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


# The train path's shapes (tiny-224's four stages at bs 24, base-384's
# last stage at 768 channels: one pass each for dγ and dβ, a thread summing
# two float4 columns), every width base-384 needs, C = 512, and row counts
# that leave CTAs short: 1, 63, 65 and fewer rows than one wave of CTAs.
@pytest.mark.parametrize("M,C", [(75264, 64), (18816, 128), (4704, 256), (1176, 512),
                                 (3456, 768), (1000, 96), (1000, 192),
                                 (1000, 384), (333, 512), (1, 64), (63, 64), (65, 128),
                                 (1, 512), (63, 96), (65, 384), (200, 512), (75, 256),
                                 (1, 768), (65, 768), (100000, 768)])
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


def _drops(dev, seed, rate=0.1, row0=0):
    """The (fc1, fc2) dropout sites of one block: keys from a seeded
    generator on the card."""
    keys = D.draw_keys(torch.Generator(device=dev).manual_seed(seed), 2)
    return D.Drop(keys[0:1], rate, row0), D.Drop(keys[1:2], rate, row0)


@pytest.mark.parametrize("row0", [0, 123457])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_masks_in_the_kernels_are_the_plain_bits(dev, rate, row0):
    """Each kernel's mask, read from an output it decides alone, equals
    ``ops.dropout.keep_mask`` bit for bit: the fc1 (GELU) and fc2 (residual)
    epilogues with a bias of 1 on zero products, the dX product's mask on
    its output (products of ones) and on dY (an identity weight), and the
    weight gradient's on dY (an identity X)."""
    M, N, bf = 512, 192, torch.bfloat16
    d1, d2 = _drops(dev, 3, rate, row0)
    mask = lambda d, rows, cols: D.keep_mask(d.key, d.row0, rows, cols, d.rate)
    zeros, ones = torch.zeros(M, 64, dtype=bf, device=dev), torch.ones(M, N, dtype=bf, device=dev)
    w0, bias1 = torch.zeros(N, 64, dtype=bf, device=dev), torch.ones(N, device=dev)
    res0 = torch.zeros(M, N, dtype=bf, device=dev)
    got = K.gemm(zeros, w0, bias1, epilogue="gelu", drop=d1) != 0
    assert torch.equal(got, mask(d1, M, N))
    got = K.gemm(zeros, w0, bias1, residual=res0, epilogue="residual", drop=d2) != 0
    assert torch.equal(got, mask(d2, M, N))
    h10 = torch.full((M, N), 10.0, dtype=bf, device=dev)
    got = K.gemm_dgrad(ones, torch.ones(N, N, device=dev), gelu_h=h10, drop_dx=d1) != 0
    assert torch.equal(got, mask(d1, M, N))
    got = K.gemm_dgrad(ones, torch.eye(N, device=dev), gelu_h=h10, drop_dy=d2) != 0
    assert torch.equal(got, mask(d2, M, N))
    dw, db = K.gemm_wgrad(torch.eye(M, dtype=bf, device=dev), ones, drop=d2)
    assert torch.equal(dw.t() != 0, mask(d2, M, N))
    kept = (torch.ones((), dtype=bf) / D.keep_divisor(rate, bf)).float().item()
    torch.testing.assert_close(db, mask(d2, M, N).float().sum(0) * kept)


@pytest.mark.parametrize("M,N,K_,hw", [(200, 96, 64, 50), (75264, 64, 256, 3136),
                                       (4704, 256, 1024, 196)])
def test_gemm_dropout_vs_plain(dev, M, N, K_, hw):
    """The three GEMMs with dropout (and drop-path) against their plain
    versions at rate 0.1: the masks' zeros in the same places, values within
    relative L2 0.02."""
    rng = np.random.default_rng(11)
    bf = torch.bfloat16
    d1, d2 = _drops(dev, 5, 0.1, row0=M)
    dp = torch.from_numpy((rng.random(M // hw) < 0.7).astype(np.float32) / 0.7).to(dev)
    a, res = _rnd(rng, dev, M, K_).to(bf), _rnd(rng, dev, M, N).to(bf)
    w, bias = _rnd(rng, dev, N, K_, sc=K_ ** -0.5).to(bf), _rnd(rng, dev, N, sc=0.1)
    for kw in (dict(epilogue="gelu", drop=d1),
               dict(epilogue="residual", residual=res, drop=d2),
               dict(epilogue="residual", residual=res, drop=d2, dp=dp, rows_per_sample=hw)):
        got, want = K.gemm(a, w, bias, **kw), K.gemm_plain(a, w, bias, **kw)
        assert _rel_l2(got.float(), want.float()) <= 0.02, kw
        if kw["epilogue"] == "gelu":
            assert torch.equal(got == 0, want == 0)
    dy, h = _rnd(rng, dev, M, K_).to(bf), _rnd(rng, dev, M, N).to(bf)
    w2 = _rnd(rng, dev, K_, N, sc=K_ ** -0.5)
    for kw in (dict(gelu_h=h, drop_dy=d2, drop_dx=d1),
               dict(gelu_h=h, drop_dy=d2, drop_dx=d1, dp=dp, rows_per_sample=hw)):
        got, want = K.gemm_dgrad(dy, w2, **kw), K.gemm_dgrad_plain(dy, w2, **kw)
        assert _rel_l2(got.float(), want.float()) <= 0.02, kw
    g = _rnd(rng, dev, M, N).to(bf)
    for kw in (dict(drop=d2), dict(drop=d2, dp=dp, rows_per_sample=hw)):
        got, want = K.gemm_wgrad(g, dy, **kw), K.gemm_wgrad_plain(g, dy, **kw)
        for x, y in zip(got, want):
            assert _rel_l2(x, y) <= 0.02, kw


@pytest.mark.parametrize("H,C,heads,split,last", [
    (56, 64, 2, 1, False), (28, 128, 4, 2, False), (14, 256, 8, 7, False),
    (7, 512, 16, 7, True), (16, 48, 2, 4, False),
    # base-384's stages 1-4: L = 96, 96, 288 and 144 at d = 24
    (96, 96, 4, 1, False), (48, 192, 8, 2, False), (24, 384, 16, 12, False),
    (12, 768, 32, 12, True)])
def test_stripe_attention_bwd(dev, H, C, heads, split, last):
    """Within 0.02 of the plain version, the same bits from two calls; a
    window longer than one key block (L > 64) takes the split route: one
    ``launches_split`` and two device kernels a launch."""
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
        for fn in (K.stripe_attention_bwd, K.stripe_attention_bwd, K.stripe_attention_bwd_plain):
            dqkv = torch.zeros(2, H, H, 3 * C, dtype=torch.bfloat16, device=dev)
            before = (K.stripe_attention_bwd.launches_split, K.device_launches())
            dw, db = fn(qkv, dout, lw, dqkv, **kw)
            if fn is K.stripe_attention_bwd:
                split_route = hs * ws > 64
                assert K.stripe_attention_bwd.launches_split == before[0] + split_route
                assert K.device_launches() == before[1] + 1 + split_route
            outs.append((dqkv[..., chans], dw, db))
        got, again, want = outs
        for g, a, w in zip(got, again, want):
            assert _rel_l2(g.float(), w.float()) <= 0.02
            assert torch.equal(g, a)


def _block_fn_case(dev, H, C, heads, split, last, seed):
    """Parameters (a last-stage block's one LePE in both slots), input,
    cotangent and drop-path multipliers of one block at B = 4."""
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=0.1, off=0.0: _rnd(rng, dev, *s, sc=sc, off=off)
    cb = C if last else C // 2
    p = [t(C, sc=0.3, off=1.0), t(C), t(3 * C, C), t(3 * C), t(cb, 1, 3, 3, sc=0.3), t(cb)]
    p += p[4:6] if last else [t(cb, 1, 3, 3, sc=0.3), t(cb)]
    p += [t(C, C), t(C), t(C, sc=0.3, off=1.0), t(C), t(4 * C, C), t(4 * C), t(C, 4 * C),
          t(C)]
    x, g = _rnd(rng, dev, 4, H, H, C).bfloat16(), _rnd(rng, dev, 4, H, H, C).bfloat16()
    dps = (torch.tensor([0.0, 1.25, 1.25, 1.25], device=dev),
           torch.tensor([1.25, 1.25, 0.0, 1.25], device=dev))
    kw = dict(heads=heads, split=split, last_stage=last, scale=(C // heads) ** -0.5, dps=dps)
    return p, x, g, kw


def _block_fn_grads(fn, p, x, g, kw, last):
    """Output and gradients of ``fn`` (input and the distinct parameters)."""
    leaves = [x.clone().requires_grad_()] + [q.clone().requires_grad_() for q in p]
    ps = leaves[1:]
    if last:  # the one LePE leaf in both slots
        ps[6], ps[7] = ps[4], ps[5]
        leaves = leaves[:7] + leaves[9:]
    out = fn(leaves[0], BlockParams(*ps), **kw)
    return [out] + list(torch.autograd.grad(out, leaves, g))


# The trained geometries: tiny-224's four stages, base-384's four (L = 96,
# 96, 288 and 144 at d = 24); the last stages run one full-window branch.
BLOCK_FN_GEOMETRIES = [(56, 64, 2, 1, False), (28, 128, 4, 2, False), (14, 256, 8, 7, False),
                       (7, 512, 16, 7, True), (96, 96, 4, 1, False), (48, 192, 8, 2, False),
                       (24, 384, 16, 12, False), (12, 768, 32, 12, True)]


@pytest.mark.parametrize("H,C,heads,split,last", BLOCK_FN_GEOMETRIES)
def test_block_fn_grads(dev, H, C, heads, split, last):
    p, x, g, kw = _block_fn_case(dev, H, C, heads, split, last, 9)
    res = [_block_fn_grads(fn, p, x, g, kw, last)
           for fn in (fused_cswin_block, composed_block)]
    for i, (a, b) in enumerate(zip(*res)):
        assert _rel_l2(a.float(), b.float()) <= 0.02, i


@pytest.mark.parametrize("H,C,heads,split,last", BLOCK_FN_GEOMETRIES)
def test_block_fn_grads_with_dropout(dev, H, C, heads, split, last):
    """``CSWinBlockFn`` at dropout 0.1 (and drop-path), its masks in the
    fc1 / fc2 epilogues and the backward GEMMs, against the composition with
    the same keys: output and every gradient within relative L2 0.02, and
    two calls bit for bit."""
    p, x, g, kw = _block_fn_case(dev, H, C, heads, split, last, 29)
    kw = dict(kw, drops=_drops(dev, 7))
    res = [_block_fn_grads(fn, p, x, g, kw, last)
           for fn in (fused_cswin_block, composed_block, fused_cswin_block)]
    for i, (a, b, c) in enumerate(zip(*res)):
        assert _rel_l2(a.float(), b.float()) <= 0.02, i
        assert torch.equal(a, c), i


@pytest.mark.parametrize("H,C,heads,split,last", BLOCK_FN_GEOMETRIES[2:4] + BLOCK_FN_GEOMETRIES[6:])
def test_block_fn_is_deterministic(dev, H, C, heads, split, last):
    """The geometries whose training route an H100 A/B chose: two calls of
    ``CSWinBlockFn`` forward and backward give the same bits."""
    p, x, g, kw = _block_fn_case(dev, H, C, heads, split, last, 19)
    first, second = (_block_fn_grads(fused_cswin_block, p, x, g, kw, last) for _ in range(2))
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


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
    """A dtype with no instance raises: float16 (bf16 and float32 have
    one each)."""
    x = torch.zeros(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        K.layernorm(x, torch.ones(64, device=dev), torch.zeros(64, device=dev))


# --- the float32 instances (TPU.COMPUTE_DTYPE float32) ----------------------

F32_TOL = 1e-5
# (H, C, heads, split, last) of every serving stage geometry: tiny-224's
# four, base-384's four (head dim 24; windows of 96, 96, 288 and 144
# tokens) and a narrow one (head dim 16).
F32_STAGES = [(56, 64, 2, 1, False), (28, 128, 4, 2, False), (14, 256, 8, 7, False),
              (7, 512, 16, 7, True), (96, 96, 4, 1, False), (48, 192, 8, 2, False),
              (24, 384, 16, 12, False), (12, 768, 32, 12, True), (16, 32, 2, 2, False)]


def _f32_batch(H):
    """B = 8 at tiny-224's stages (the serving slices), fewer at base-384's
    wider ones."""
    return 8 if H <= 56 and H != 24 and H != 12 else 2


@pytest.mark.parametrize("C", [32, 64, 96, 128, 192, 256, 384, 512, 768, 1024])
@pytest.mark.parametrize("rows", [1, 3001])
def test_f32_layernorm(dev, C, rows):
    rng = np.random.default_rng(40)
    x = _rnd(rng, dev, rows, C, sc=2.0, off=0.5)
    w, b = _rnd(rng, dev, C, sc=0.3, off=1.0), _rnd(rng, dev, C, sc=0.1)
    before = (K.layernorm.launches, K.layernorm.launches_f32)
    got = K.layernorm(x, w, b)
    assert (K.layernorm.launches, K.layernorm.launches_f32) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32
    assert _rel_l2(got, K.layernorm_plain(x, w, b)) <= F32_TOL


@pytest.mark.parametrize("H,C,heads,split,last", F32_STAGES)
def test_f32_gemm_stage_shapes(dev, H, C, heads, split, last):
    """The block's four GEMMs at each stage's shapes (qkv bias, proj and
    fc2 residual with and without a drop-path scale, fc1 GELU)."""
    rng = np.random.default_rng(41)
    B = _f32_batch(H)
    M = B * H * H
    x, h, r = _rnd(rng, dev, M, C), _rnd(rng, dev, M, 4 * C), _rnd(rng, dev, M, C)
    dp = torch.from_numpy((rng.random(B) < 0.7).astype(np.float32) / 0.7).to(dev)
    for a, n, epi, res, scale in ((x, 3 * C, "bias", None, None), (x, C, "residual", r, None),
                                  (x, 4 * C, "gelu", None, None), (h, C, "residual", r, dp)):
        w = _rnd(rng, dev, n, a.shape[1], sc=a.shape[1] ** -0.5)
        bias = _rnd(rng, dev, n, sc=0.1)
        kw = dict(residual=res, epilogue=epi, dp=scale, rows_per_sample=H * H if scale is not None else 0)
        before = K.gemm.launches_f32
        got = K.gemm(a, w, bias, **kw)
        assert K.gemm.launches_f32 == before + 1 and got.dtype == torch.float32
        assert _rel_l2(got, K.gemm_plain(a, w, bias, **kw)) <= F32_TOL, (n, epi)


@pytest.mark.parametrize("M,N,K_", [(1, 8, 4), (130, 25, 36), (200, 96, 64), (64, 512, 2048)])
def test_f32_gemm_ragged_edges(dev, M, N, K_):
    """M, N and K that are no multiple of the 64 x 64 x 16 tile."""
    rng = np.random.default_rng(42)
    a, w = _rnd(rng, dev, M, K_), _rnd(rng, dev, N, K_, sc=K_ ** -0.5)
    bias, r = _rnd(rng, dev, N, sc=0.1), _rnd(rng, dev, M, N)
    for epi, res in (("bias", None), ("residual", r), ("gelu", None)):
        got = K.gemm(a, w, bias, residual=res, epilogue=epi)
        assert _rel_l2(got, K.gemm_plain(a, w, bias, residual=res, epilogue=epi)) <= F32_TOL


def test_f32_gemm_refuses_training_epilogues(dev):
    """The float32 instance takes the training epilogues (``pre``, ``drop``);
    a dtype with no instance (float16) is refused, and so is K % 4."""
    a = torch.zeros(64, 64, device=dev)
    w = torch.zeros(64, 64, device=dev)
    pre = torch.empty_like(a)
    d1, _ = _drops(dev, 1)
    got = K.gemm(a, w, torch.ones(64, device=dev), epilogue="gelu", pre=pre, drop=d1)
    assert got.dtype == torch.float32 and torch.equal(pre, torch.ones_like(pre))
    with pytest.raises(TypeError):
        K.gemm(a.half(), w.half(), None, epilogue="gelu", pre=pre.half())
    with pytest.raises(ValueError):  # K % 4
        K.gemm(torch.zeros(8, 6, device=dev), torch.zeros(8, 6, device=dev))


def _f32_branches(H, C, heads, split, last):
    if last:
        return [(0, C, heads, H, H)]
    return [(0, C // 2, heads // 2, H, split), (C // 2, C // 2, heads // 2, split, H)]


@pytest.mark.parametrize("H,C,heads,split,last", F32_STAGES)
def test_f32_stripe_attention(dev, H, C, heads, split, last):
    """Every branch of every serving geometry, from the qkv GEMM's output,
    written at the branch's channel offset."""
    rng = np.random.default_rng(43)
    B = _f32_batch(H)
    qkv = _rnd(rng, dev, B, H, H, 3 * C)
    scale = (C // heads) ** -0.5
    for off, cb, nh, hs, ws in _f32_branches(H, C, heads, split, last):
        lw, lb = _rnd(rng, dev, cb, 1, 3, 3, sc=0.3), _rnd(rng, dev, cb, sc=0.1)
        kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=scale)
        out = torch.zeros(B, H, H, C, device=dev)
        before = K.stripe_attention.launches_f32
        got = K.stripe_attention(qkv, lw, lb, out, **kw)[..., off:off + cb]
        assert K.stripe_attention.launches_f32 == before + 1
        want = K.stripe_attention_plain(qkv, lw, lb, torch.zeros_like(out), **kw)
        assert _rel_l2(got, want[..., off:off + cb]) <= F32_TOL, (hs, ws)
        assert not out[..., :off].any() and not out[..., off + cb:].any()


@pytest.mark.parametrize("H,C,heads,split,last", F32_STAGES)
def test_f32_cswin_attention(dev, H, C, heads, split, last):
    """The pallas route's entry on q, k, v slices of one qkv tensor."""
    from cswin_unet_tpu_torch.ops.attention import cswin_attention_pallas_plain

    rng = np.random.default_rng(44)
    B = _f32_batch(H)
    qkv = _rnd(rng, dev, B, H, H, 3, C)
    for off, cb, nh, hs, ws in _f32_branches(H, C, heads, split, last):
        q, k, v = (qkv[..., i, off:off + cb] for i in range(3))
        lw, lb = _rnd(rng, dev, cb, 1, 3, 3, sc=0.3), _rnd(rng, dev, cb, sc=0.1)
        kw = dict(h_sp=hs, w_sp=ws, num_heads=nh, scale=(C // heads) ** -0.5)
        before = K.cswin_attention.launches_f32
        got = K.cswin_attention(q, k, v, lw, lb, **kw)
        assert K.cswin_attention.launches_f32 == before + 1 and got.dtype == torch.float32
        assert _rel_l2(got, cswin_attention_pallas_plain(q, k, v, lw, lb, **kw)) <= F32_TOL


@pytest.mark.parametrize("L,d", [(49, 32), (56, 32), (98, 32), (96, 24), (144, 24),
                                 (288, 24), (288, 32), (30, 16)])
def test_f32_attention_plan_is_the_kernels(dev, L, d):
    from cswin_unet_tpu_torch.ops.cuda.build import library

    assert library().cswin_stripe_attention_f32_smem(L, d) == K.attention_f32_plan(L, d).smem_bytes


# (label, C in, C out, up, nc): tiny-224's two fused CARAFE sites, base-384's,
# and the tail at the continual heads' 12 and 14 classes.
F32_CARAFE_SITES = [("up@28", 128, 64, 2, None, 28), ("tail@56", 64, 64, 4, 9, 56),
                    ("tail@56 nc12", 64, 64, 4, 12, 56), ("tail@56 nc14", 64, 64, 4, 14, 56),
                    ("up@48", 192, 96, 2, None, 48), ("tail@96", 96, 96, 4, 9, 96)]


@pytest.mark.parametrize("label,C,C_out,up,nc,H", F32_CARAFE_SITES)
def test_f32_carafe_sites(dev, label, C, C_out, up, nc, H):
    """The whole fused CARAFE site (GEMM + CARAFE, both float32) against
    its plain composition: logits, and for the tail the labels by the margin
    rule; and an image that is no multiple of the 8x8 tile."""
    rng = np.random.default_rng(45)
    p = _carafe_params(rng, dev, C, C_out, up, nc)
    for B, h, w in ((8 if H < 96 else 2, H, H), (2, 11, 13)):
        x = _rnd(rng, dev, B, h, w, C)
        before = K.carafe_reassemble.launches_f32
        if nc is None:
            got, want = carafe_up(x, *p), carafe_up_plain(x, *p)
        else:
            got, want = carafe_tail(x, *p), carafe_tail_plain(x, *p)
        assert K.carafe_reassemble.launches_f32 == before + 1
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel_l2(got, want) <= F32_TOL, label
        if nc is not None:
            labels = carafe_tail_argmax(x, *p)
            assert labels.dtype == torch.int32 and labels.shape == want.shape[:-1]
            assert _margin_mismatches(labels, want) == 0


@pytest.mark.parametrize("nc", [9, 12, 14])
@pytest.mark.parametrize("H,W", [(13, 21), (56, 56)])
def test_f32_carafe_tied_labels(dev, nc, H, W):
    """The float32 tail's labels where classes tie: y's classes come in
    equal pairs (2i, 2i + 1), so every maximum is tied and the first wins:
    every label is even; against the plain float32 logits by the margin
    rule; the logits within 1e-5 of plain."""
    rng = np.random.default_rng(49)
    cm, up = 16, 4
    G = -(-(cm + nc) // 8) * 8
    mid = _rnd(rng, dev, 4, H, W, cm)
    half = _rnd(rng, dev, 4, H, W, (nc + 1) // 2)
    y = half.repeat_interleave(2, dim=-1)[..., :nc]
    gy = torch.cat([mid, y, torch.zeros(4, H, W, G - cm - nc, device=dev)], -1).contiguous()
    ew, eb = _rnd(rng, dev, 9 * up * up, cm, 3, 3, sc=0.2), _rnd(rng, dev, 9 * up * up)
    bo = _rnd(rng, dev, (nc + 1) // 2).repeat_interleave(2)[:nc].contiguous()
    kw = dict(c_mid=cm, up=up)
    labels = K.carafe_reassemble(gy, ew, eb, bo, labels=True, **kw)
    logits = K.carafe_reassemble(gy, ew, eb, bo, labels=False, **kw)
    want = K.carafe_reassemble_plain(gy, ew, eb, bo, labels=False, **kw)
    assert labels.shape == (4, H * up, W * up) and bool((labels % 2 == 0).all())
    assert _margin_mismatches(labels, want) == 0
    assert _rel_l2(logits, want) <= F32_TOL


@pytest.mark.parametrize("cm,nc,up", [(6, 5, 2), (6, 7, 4), (10, 3, 4)])
def test_f32_carafe_odd_channels(dev, cm, nc, up):
    """The float32 kernel at a c_mid and nc that are no multiples of 4 (mid
    zero-padded in the halo, y and the logits one value at a time), on an
    image that is no multiple of the tile: within 1e-5 of plain; the labels
    by the margin rule."""
    rng = np.random.default_rng(50)
    G = -(-(cm + nc) // 4) * 4
    gy = _rnd(rng, dev, 3, 11, 13, G)
    ew, eb = _rnd(rng, dev, 9 * up * up, cm, 3, 3, sc=0.2), _rnd(rng, dev, 9 * up * up)
    bo = _rnd(rng, dev, nc)
    kw = dict(c_mid=cm, up=up)
    want = K.carafe_reassemble_plain(gy, ew, eb, bo, labels=False, **kw)
    assert _rel_l2(K.carafe_reassemble(gy, ew, eb, bo, labels=False, **kw), want) <= F32_TOL
    labels = K.carafe_reassemble(gy, ew, eb, bo, labels=True, **kw)
    assert _margin_mismatches(labels, want) == 0


@pytest.mark.parametrize("cm,nc,G,up", [(16, 9, 32, 4), (32, 64, 96, 2), (24, 9, 40, 4),
                                        (48, 96, 144, 2), (16, 14, 32, 4)])
def test_f32_carafe_plan_is_the_kernels(dev, cm, nc, G, up):
    from cswin_unet_tpu_torch.ops.cuda.build import library

    assert library().cswin_carafe_f32_smem(cm, nc, G, up) == K.carafe_f32_plan(cm, nc, G,
                                                                              up).smem_bytes


@pytest.mark.parametrize("H,C,heads,split", [(28, 128, 4, 2), (14, 256, 8, 7),
                                             (24, 384, 16, 12)])
def test_f32_block_pair(dev, H, C, heads, split):
    """The float32 pair at the pairable stages (tiny-224's 2 and 3, B =
    32; base-384's stage 3, B = 2): bit for bit against two float32 block
    chains, within 1e-5 of its plain version."""
    rng = np.random.default_rng(46)
    p1, p2 = _block_params(rng, dev, C), _block_params(rng, dev, C)
    x = _rnd(rng, dev, 32 if C <= 256 else 2, H, H, C)
    kw = dict(heads=heads, split=split, scale=(C // heads) ** -0.5)
    before = K.block_pair.launches_f32
    got = K.block_pair(x, p1, p2, **kw)
    assert K.block_pair.launches_f32 == before + 1 and got.dtype == torch.float32
    smem = K.block_pair_f32_smem(H, H, C, heads, split)
    grid = K.block_pair.grid
    print(f"block_pair_f32 @{H}x{H}x{C}: grid {grid}")
    assert grid["smem_bytes"] == smem
    # the register cap's CTAs an SM, where shared memory leaves room for them
    assert grid["ctas_per_sm"] == min(K._PAIR_F32_CTAS, K._SM_SMEM // (smem + 1024)), grid
    chain = fused_cswin_block(fused_cswin_block(x, p1, last_stage=False, **kw), p2,
                              last_stage=False, **kw)
    assert torch.equal(got, chain)
    assert _rel_l2(got, K.block_pair_plain(x, p1, p2, **kw)) <= F32_TOL


def test_f32_block_pair_phases(dev):
    """The float32 pair stopped after its first block's qkv phase gives the
    chain's LN1 + qkv bit for bit; after the attention and proj phases
    finite outputs of the block's shape; no stop counts a pair launch."""
    rng = np.random.default_rng(48)
    H, C, heads, split = 14, 256, 8, 7
    p1, p2 = _block_params(rng, dev, C), _block_params(rng, dev, C)
    x = _rnd(rng, dev, 32, H, H, C)
    kw = dict(heads=heads, split=split, scale=(C // heads) ** -0.5)
    before = K.block_pair.launches_f32
    qkv = K.block_pair_phases(x, p1, p2, stop="qkv", **kw)
    rows = x.reshape(-1, C)
    want = K.gemm(K.layernorm(rows, p1.norm1_w, p1.norm1_b), p1.qkv_w, p1.qkv_b)
    assert torch.equal(qkv, want)
    for stop in ("attention", "proj"):
        out = K.block_pair_phases(x, p1, p2, stop=stop, **kw)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert K.block_pair.launches_f32 == before


@pytest.mark.parametrize("H,C,heads,split,last", F32_STAGES)
def test_f32_block_chain(dev, H, C, heads, split, last):
    rng = np.random.default_rng(47)
    p = _block_params(rng, dev, C, last)
    x = _rnd(rng, dev, 2, H, H, C)
    kw = dict(heads=heads, split=split, last_stage=last, scale=(C // heads) ** -0.5)
    got = fused_cswin_block(x, p, **kw)
    assert got.dtype == torch.float32
    assert _rel_l2(got, composed_block(x, p, **kw)) <= F32_TOL


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_f32_model_routes(dev, impl, monkeypatch):
    """The tiny-224 model (full width, depth cut to 2 at every stage) at
    float32 on the kernel route against the plain route: logits within
    1e-4, labels by the margin rule, and only float32 instances launched.
    The routing pairs no geometry at float32 (``PAIR_GEOMETRIES``); with
    the bf16 route's pairs forced on at float32 the fused route launches
    the float32 pair too and gives the same logits bit for bit."""
    from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
    from cswin_unet_tpu_torch.ops.cuda import cswin_block

    rng = np.random.default_rng(48)
    torch.manual_seed(0)
    geo = dict(img_size=224, num_classes=9, embed_dim=64, depth=(2, 2, 2, 2),
               split_size=(1, 2, 7, 7), num_heads=(2, 4, 8, 16), dtype=torch.float32)
    plain = CSwinUnet(CSWinUNet(**geo, impl="plain")).eval()
    model = CSwinUnet(CSWinUNet(**geo, impl=impl)).eval()
    model.load_state_dict(plain.state_dict())
    plain, model = plain.to(dev), model.to(dev)
    x = _rnd(rng, dev, 4, 224, 224, 1)
    with torch.inference_mode():
        want = plain(x)
        K.reset_launch_counts()
        got = model(x)
        counts = K.launch_counts()
        labels = model(x, emit="labels")
    assert _rel_l2(got, want) <= 1e-4
    assert _margin_mismatches(labels, want) == 0
    names = [k.__name__ for k in K.F32_KERNELS]
    assert all(counts[n] == counts[f"{n}_f32"] for n in names), counts
    launched = {n for n in names if counts[n]}
    assert launched == ({"cswin_attention"} if impl == "pallas" else
                        {"layernorm", "gemm", "stripe_attention", "carafe_reassemble"}), counts
    if impl == "fused":
        committed = cswin_block.pair_fuse_ok
        monkeypatch.setattr(cswin_block, "pair_fuse_ok",
                            lambda H, W, C, dtype=None: committed(H, W, C, torch.bfloat16))
        with torch.inference_mode():
            K.reset_launch_counts()
            paired = model(x)
            counts = K.launch_counts()
        assert counts["block_pair_f32"] > 0 and torch.equal(paired, got), counts


# --- the float32 backward (training at TPU.COMPUTE_DTYPE float32) ----------
#
# Each float32 backward instance against its plain float32 version at
# relative L2 <= F32_TOL. A sum over M (gemm_wgrad's dW and db, LN's dγ and
# dβ, the LePE partials) that misses it passes only if its error against a
# float64 oracle is at most twice the plain version's (two float32 sums of
# ~10^4-10^5 terms in different orders differ by more than 1e-5 at worst).

# (H, C, heads, split, last) of every training geometry: tiny-224's four
# stages and base-384's four (head dim 24; windows of 96, 96, 288, 144).
F32_TRAIN = F32_STAGES[:8]


def _reduction_ok(got, plain, oracle64) -> bool:
    if _rel_l2(got, plain) <= F32_TOL:
        return True
    return _rel_l2(got, oracle64) <= 2 * _rel_l2(plain, oracle64)


def _train_batch(H):
    """B = 4 at tiny-224's stages, 2 at base-384's (the geometry, not the
    batch, sets the kernels' paths; the plans follow M)."""
    return 4 if H in (56, 28, 14, 7) else 2


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("H,C,heads,split,last", F32_TRAIN + [(1, 32, 1, 1, True)])
def test_f32_layernorm_bwd(dev, H, C, heads, split, last, residual):
    """Every trained width (C = 64-512 and 768), and rows that leave CTAs
    short; deterministic."""
    rng = np.random.default_rng(50)
    for M in (_train_batch(H) * H * H, 65, 1):
        x, dy, res = (_rnd(rng, dev, M, C, sc=2.0, off=0.3) for _ in range(3))
        w = _rnd(rng, dev, C, sc=0.3, off=1.0)
        r = res if residual else None
        before = (K.layernorm_bwd.launches, K.layernorm_bwd.launches_f32)
        got = K.layernorm_bwd(x, dy, w, residual=r)
        again = K.layernorm_bwd(x, dy, w, residual=r)
        assert (K.layernorm_bwd.launches, K.layernorm_bwd.launches_f32) == (
            before[0] + 2, before[1] + 2)
        want = K.layernorm_bwd_plain(x, dy, w, residual=r)
        x64, dy64 = x.double(), dy.double()
        mu = x64.mean(-1, keepdim=True)
        xhat = (x64 - mu) * torch.rsqrt(((x64 - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        oracle = ((dy64 * xhat).sum(0), dy64.sum(0))
        assert got[0].dtype == torch.float32
        assert _rel_l2(got[0], want[0]) <= F32_TOL, (M, C)
        for g, p, o in zip(got[1:], want[1:], oracle):
            assert _reduction_ok(g, p, o), (M, C, _rel_l2(g, p), _rel_l2(g, o), _rel_l2(p, o))
        for g, a in zip(got, again):
            assert torch.equal(g, a)  # deterministic


def _f32_dgrad_cases(rng, dev, M, C, hw, B):
    """The block's four dX products: fc2 with the GELU backward (and the
    drop-path scale), fc1, proj (drop-path), qkv."""
    dp = torch.from_numpy((rng.random(B) < 0.7).astype(np.float32) / 0.7).to(dev)
    h = _rnd(rng, dev, M, 4 * C)
    return [("fc2-gelu_bwd", C, 4 * C, dict(dp=dp, rows_per_sample=hw, gelu_h=h)),
            ("fc2-gelu_bwd", C, 4 * C, dict(gelu_h=h)),
            ("fc1", 4 * C, C, {}), ("proj+droppath", C, C, dict(dp=dp, rows_per_sample=hw)),
            ("qkv", 3 * C, C, {})]


@pytest.mark.parametrize("H,C,heads,split,last", F32_TRAIN)
def test_f32_gemm_dgrad(dev, H, C, heads, split, last):
    rng = np.random.default_rng(51)
    B = _train_batch(H)
    M, hw = B * H * H, H * H
    for what, n, k, kw in _f32_dgrad_cases(rng, dev, M, C, hw, B):
        d, w = _rnd(rng, dev, M, n), _rnd(rng, dev, n, k, sc=n ** -0.5)
        before = K.gemm_dgrad.launches_f32
        got = K.gemm_dgrad(d, w, **kw)
        assert K.gemm_dgrad.launches_f32 == before + 1 and got.dtype == torch.float32
        assert _rel_l2(got, K.gemm_dgrad_plain(d, w, **kw)) <= F32_TOL, what


@pytest.mark.parametrize("droppath", [False, True])
@pytest.mark.parametrize("H,C,heads,split,last", F32_TRAIN)
def test_f32_gemm_wgrad(dev, H, C, heads, split, last, droppath):
    """The block's four weight gradients (fc2, fc1, proj, qkv) at each
    geometry; dW and db by the reduction rule; two calls the same bits."""
    rng = np.random.default_rng(52)
    B = _train_batch(H)
    M, hw = B * H * H, H * H
    dp = torch.from_numpy((rng.random(B) < 0.7).astype(np.float32) / 0.7).to(dev)
    kw = dict(dp=dp, rows_per_sample=hw) if droppath else {}
    for k, n in ((4 * C, C), (C, 4 * C), (C, C), (C, 3 * C)):
        x, d = _rnd(rng, dev, M, k), _rnd(rng, dev, M, n)
        before = K.gemm_wgrad.launches_f32
        got, again = K.gemm_wgrad(x, d, **kw), K.gemm_wgrad(x, d, **kw)
        assert K.gemm_wgrad.launches_f32 == before + 2
        want = K.gemm_wgrad_plain(x, d, **kw)
        d64 = d.double() * (dp.double().repeat_interleave(hw)[:, None] if droppath else 1)
        oracle = (d64.t() @ x.double(), d64.sum(0))
        for g, a, p, o in zip(got, again, want, oracle):
            assert g.dtype == torch.float32 and g.shape == p.shape
            assert _reduction_ok(g, p, o), (k, n, _rel_l2(g, p), _rel_l2(g, o), _rel_l2(p, o))
            assert torch.equal(g, a)


def _lepe_grads64(qkv, dout, ch_off, cb, h_sp, w_sp):
    """The LePE weight and bias gradients of one branch in float64."""
    from cswin_unet_tpu_torch.ops.windows import window_partition

    C = dout.shape[-1]
    v = qkv[..., 2 * C + ch_off:2 * C + ch_off + cb].double()
    do = dout[..., ch_off:ch_off + cb].double()
    v_img = window_partition(v, h_sp, w_sp).reshape(-1, h_sp, w_sp, cb)
    do_img = window_partition(do, h_sp, w_sp).reshape(-1, h_sp, w_sp, cb)
    v_pad = torch.nn.functional.pad(v_img, (0, 0, 1, 1, 1, 1))
    dw = torch.stack([(do_img * v_pad[:, a:a + h_sp, b:b + w_sp]).sum((0, 1, 2))
                      for a in range(3) for b in range(3)], dim=-1)
    return dw.reshape(cb, 1, 3, 3), do_img.sum((0, 1, 2))


@pytest.mark.parametrize("H,C,heads,split,last", F32_STAGES)
def test_f32_stripe_attention_bwd(dev, H, C, heads, split, last):
    """Both branches of every training geometry (and the narrow head dim 16
    one): dq, dk, dv within F32_TOL, the LePE partials by the reduction
    rule, two calls the same bits."""
    rng = np.random.default_rng(53)
    B = _train_batch(H)
    qkv, dout = _rnd(rng, dev, B, H, H, 3 * C), _rnd(rng, dev, B, H, H, C)
    for off, cb, nh, hs, ws in _f32_branches(H, C, heads, split, last):
        lw = _rnd(rng, dev, cb, 1, 3, 3, sc=0.3)
        kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=(C // heads) ** -0.5)
        chans = torch.cat([torch.arange(off, off + cb) + i * C for i in range(3)]).to(dev)

        def run(fn):
            dqkv = torch.zeros(B, H, H, 3 * C, device=dev)
            dw, db = fn(qkv, dout, lw, dqkv, **kw)
            return dqkv[..., chans], dw, db

        before = K.stripe_attention_bwd.launches_f32
        got, again = run(K.stripe_attention_bwd), run(K.stripe_attention_bwd)
        assert K.stripe_attention_bwd.launches_f32 == before + 2
        want = run(K.stripe_attention_bwd_plain)
        assert _rel_l2(got[0], want[0]) <= F32_TOL, (hs, ws)
        for g, p, o in zip(got[1:], want[1:], _lepe_grads64(qkv, dout, off, cb, hs, ws)):
            assert _reduction_ok(g, p, o), (hs, ws, _rel_l2(g, p), _rel_l2(g, o))
        for g, a in zip(got, again):
            assert torch.equal(g, a)


@pytest.mark.parametrize("source,entries", [
    ("stripe_attention.cu", ("stripe_attention_f32_kernel",)),
    ("stripe_attention_bwd.cu", ("stripe_attention_bwd_f32_rows_kernel",
                                 "stripe_attention_bwd_f32_keys_kernel")),
    # the bf16 backward's split route, its row (part 1) and key (part 2)
    # kernels at head dims 24 and 32, by their mangled instances
    ("stripe_attention_bwd.cu", ("stripe_attention_bwd_kernelILi24ELi1E",
                                 "stripe_attention_bwd_kernelILi24ELi2E",
                                 "stripe_attention_bwd_kernelILi32ELi1E",
                                 "stripe_attention_bwd_kernelILi32ELi2E"))])
def test_f32_attention_kernels_do_not_spill(dev, tmp_path, source, entries):
    """ptxas -v of the float32 attention kernels (every head dim) and of the
    bf16 backward's split route: registers and no spill stores or loads."""
    import re
    import subprocess

    from cswin_unet_tpu_torch.ops.cuda import build

    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-c", str(build.CSRC / source),
                          "-o", str(tmp_path / "k.o")], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, check=True).stdout
    seen, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:  # the first such line after an entry is the entry's
            if any(e in current for e in entries):
                seen.append(current)
                assert m.group(1) == m.group(2) == "0", (current, line)
            current = None
    # a name is every head dim's instance (16, 24, 32); a mangled instance one
    assert len(seen) == sum(1 if "ILi" in e else 3 for e in entries), seen


@pytest.mark.parametrize("L,d", [(49, 32), (56, 32), (98, 32), (96, 24), (144, 24),
                                 (288, 24), (288, 32), (30, 16)])
def test_f32_attention_bwd_plan_is_the_kernels(dev, L, d):
    from cswin_unet_tpu_torch.ops.cuda.build import library

    plan = K.stripe_attention_bwd_f32_plan(L, d)
    want = (plan.rows_smem, plan.keys_smem, plan.row_block, plan.key_blocks_per_cta)
    got = tuple(library().cswin_stripe_attention_bwd_f32_smem(L, d, what) for what in range(4))
    assert got == want
    assert max(plan.rows_smem, plan.keys_smem) <= K.SMEM_LIMIT
    assert library().cswin_stripe_attention_bwd_f32_smem(L, d, 4) == 0


@pytest.mark.parametrize("row0", [0, 123457])
def test_f32_dropout_masks_are_the_plain_bits(dev, row0):
    """The float32 instances' masks, read as in the bf16 test: the fc1 and
    fc2 epilogues, the dX product's masks on its output and on dY, the
    weight gradient's on dY; kept values v / keep."""
    M, N = 512, 192
    d1, d2 = _drops(dev, 3, 0.1, row0)
    mask = lambda d, rows, cols: D.keep_mask(d.key, d.row0, rows, cols, d.rate)
    zeros, ones = torch.zeros(M, 64, device=dev), torch.ones(M, N, device=dev)
    w0, bias1, res0 = torch.zeros(N, 64, device=dev), torch.ones(N, device=dev), \
        torch.zeros(M, N, device=dev)
    got = K.gemm(zeros, w0, bias1, epilogue="gelu", drop=d1) != 0
    assert torch.equal(got, mask(d1, M, N))
    got = K.gemm(zeros, w0, bias1, residual=res0, epilogue="residual", drop=d2)
    assert torch.equal(got != 0, mask(d2, M, N))
    kd = D.keep_divisor(0.1, torch.float32)
    assert torch.equal(got[got != 0], torch.full_like(got[got != 0], 1.0 / kd))
    h10 = torch.full((M, N), 10.0, device=dev)
    got = K.gemm_dgrad(ones, torch.ones(N, N, device=dev), gelu_h=h10, drop_dx=d1) != 0
    assert torch.equal(got, mask(d1, M, N))
    got = K.gemm_dgrad(ones, torch.eye(N, device=dev), gelu_h=h10, drop_dy=d2) != 0
    assert torch.equal(got, mask(d2, M, N))
    dw, db = K.gemm_wgrad(torch.eye(M, device=dev), ones, drop=d2)
    assert torch.equal(dw.t() != 0, mask(d2, M, N))


@pytest.mark.parametrize("H,C,heads,split,last", F32_TRAIN[:4])
def test_f32_gemm_dropout_vs_plain(dev, H, C, heads, split, last):
    """The float32 GEMMs' dropout instances (with drop-path) at tiny-224's
    shapes, rate 0.1: the forward's fc1 (keeping its pre-activation) and
    fc2, the fc2 dX product with both masks, its weight gradient."""
    rng = np.random.default_rng(54)
    B = _train_batch(H)
    M, hw = B * H * H, H * H
    d1, d2 = _drops(dev, 5, 0.1, row0=M)
    dp = torch.from_numpy((rng.random(B) < 0.7).astype(np.float32) / 0.7).to(dev)
    x, res, h = _rnd(rng, dev, M, C), _rnd(rng, dev, M, C), _rnd(rng, dev, M, 4 * C)
    w1, b1 = _rnd(rng, dev, 4 * C, C, sc=C ** -0.5), _rnd(rng, dev, 4 * C, sc=0.1)
    w2, b2 = _rnd(rng, dev, C, 4 * C, sc=(4 * C) ** -0.5), _rnd(rng, dev, C, sc=0.1)
    pre_k, pre_p = torch.empty(M, 4 * C, device=dev), torch.empty(M, 4 * C, device=dev)
    got = K.gemm(x, w1, b1, epilogue="gelu", pre=pre_k, drop=d1)
    want = K.gemm_plain(x, w1, b1, epilogue="gelu", pre=pre_p, drop=d1)
    assert _rel_l2(got, want) <= F32_TOL and _rel_l2(pre_k, pre_p) <= F32_TOL
    assert torch.equal(got == 0, want == 0)
    kw = dict(epilogue="residual", residual=res, drop=d2, dp=dp, rows_per_sample=hw)
    assert _rel_l2(K.gemm(h, w2, b2, **kw), K.gemm_plain(h, w2, b2, **kw)) <= F32_TOL
    dy, wt = _rnd(rng, dev, M, C), _rnd(rng, dev, C, 4 * C, sc=C ** -0.5)
    kw = dict(gelu_h=h, drop_dy=d2, drop_dx=d1, dp=dp, rows_per_sample=hw)
    assert _rel_l2(K.gemm_dgrad(dy, wt, **kw), K.gemm_dgrad_plain(dy, wt, **kw)) <= F32_TOL
    kw = dict(drop=d2, dp=dp, rows_per_sample=hw)
    for g, p in zip(K.gemm_wgrad(h, dy, **kw), K.gemm_wgrad_plain(h, dy, **kw)):
        o = None
        if _rel_l2(g, p) > F32_TOL:  # the reduction rule, against float64
            m = D.keep_mask(d2.key, d2.row0, M, C, 0.1).double() / D.keep_divisor(
                0.1, torch.float32)
            d64 = dy.double() * dp.double().repeat_interleave(hw)[:, None] * m
            o = d64.t() @ h.double() if g.dim() == 2 else d64.sum(0)
        assert o is None or _reduction_ok(g, p, o)


@pytest.mark.parametrize("H,C,heads,split,last", F32_TRAIN)
def test_f32_block_fn_grads(dev, H, C, heads, split, last):
    """``CSWinBlockFn`` at float32 (drop-path live) against autograd through
    the float32 composition: output and every gradient within 1e-4 (a chain
    of 14 kernels a block, each within 1e-5 of its plain version); only
    float32 instances launched."""
    p, x, g, kw = _block_fn_case(dev, H, C, heads, split, last, 59)
    x, g = x.float(), g.float()
    K.reset_launch_counts()
    res = [_block_fn_grads(fn, p, x, g, kw, last)
           for fn in (fused_cswin_block, composed_block)]
    counts = K.launch_counts()
    for i, (a, b) in enumerate(zip(*res)):
        assert a.dtype == torch.float32
        assert _rel_l2(a, b) <= 1e-4, i
    for k in ("layernorm_bwd", "gemm_dgrad", "gemm_wgrad", "stripe_attention_bwd"):
        assert counts[k] == counts[f"{k}_f32"] > 0, counts


def test_f32_conv_weight_grad_is_float32(dev):
    """One float32 convolution's weight gradient through the port's conv
    (``ops.precision.conv2d``) with cuDNN's TF32 flag at PyTorch's default
    (True): within 1e-5 of float64, as the backward runs with TF32 off; the
    stock ``F.conv2d``'s is printed beside it."""
    from cswin_unet_tpu_torch.ops.precision import conv2d

    rng = np.random.default_rng(55)
    x, w = _rnd(rng, dev, 8, 64, 56, 56), _rnd(rng, dev, 128, 64, 3, 3, sc=0.05)
    gy = _rnd(rng, dev, 8, 128, 28, 28)
    torch.backends.cudnn.allow_tf32 = True
    try:
        grads = []
        for fn in (conv2d, torch.nn.functional.conv2d):
            wl = w.clone().requires_grad_()
            out = fn(x, wl, None, 2, 1)
            grads.append(torch.autograd.grad(out, wl, gy)[0])
        assert torch.backends.cudnn.allow_tf32  # the port's conv left the flag as it was
    finally:
        torch.backends.cudnn.allow_tf32 = False
    w64 = w.double().requires_grad_()
    out = torch.nn.functional.conv2d(x.double(), w64, None, 2, 1)
    want = torch.autograd.grad(out, w64, gy.double())[0]
    errs = [_rel_l2(gw, want) for gw in grads]
    print(f"conv weight gradient vs float64: port {errs[0]:.3e}, F.conv2d with TF32 "
          f"{errs[1]:.3e}")
    assert errs[0] <= 1e-5


# --- the float32 GEMM tiles and the float32 weight gradient's plan ---------
#
# gemm_f32.cu's forward / dX kernel runs one of its tiles, chosen by
# kernels.gemm_f32_plan from the shape; every tile sums each output as one
# fmaf chain over k in order and applies the epilogue in tile_f32's order, so
# all give the same bits (and the pair's tile_f32 too: test_f32_block_pair).
# The weight gradient's split plan (kernels.wgrad_f32_plan) is its own.

def _f32_stage_batches():
    """(H, C, B) of every training geometry of tiny-224 (B = 4) and base-384
    (B = 2)."""
    return [(H, C, _train_batch(H)) for H, C, *_ in F32_TRAIN]


@pytest.mark.parametrize("H,C,B", _f32_stage_batches())
def test_f32_gemm_tiles_give_the_same_bits(dev, monkeypatch, H, C, B):
    """Each epilogue (bias; residual with and without the drop-path scale;
    GELU with the kept pre-activation; the dropout instances) and each dX
    product (plain, scaled, GELU backward, both masks) through every tile:
    equal bits across tiles, within F32_TOL of plain."""
    rng = np.random.default_rng(60)
    M, hw = B * H * H, H * H
    x, h, r = _rnd(rng, dev, M, C), _rnd(rng, dev, M, 4 * C), _rnd(rng, dev, M, C)
    dp = torch.from_numpy((rng.random(B) < 0.7).astype(np.float32) / 0.7).to(dev)
    w1, b1 = _rnd(rng, dev, 4 * C, C, sc=C ** -0.5), _rnd(rng, dev, 4 * C, sc=0.1)
    w2, b2 = _rnd(rng, dev, C, 4 * C, sc=(4 * C) ** -0.5), _rnd(rng, dev, C, sc=0.1)
    wp = _rnd(rng, dev, C, C, sc=C ** -0.5)
    d1, d2 = _drops(dev, 61)
    pre = {}

    def fc1(drop):
        pre[drop is None] = torch.empty(M, 4 * C, device=dev)
        return K.gemm(x, w1, b1, epilogue="gelu", pre=pre[drop is None], drop=drop)

    cases = {
        "qkv": (lambda: K.gemm(x, w1, b1),
                lambda: K.gemm_plain(x, w1, b1)),
        "proj": (lambda: K.gemm(x, wp, b2, residual=r, epilogue="residual"),
                 lambda: K.gemm_plain(x, wp, b2, residual=r, epilogue="residual")),
        "fc2+dp": (lambda: K.gemm(h, w2, b2, residual=r, epilogue="residual", dp=dp,
                                  rows_per_sample=hw),
                   lambda: K.gemm_plain(h, w2, b2, residual=r, epilogue="residual", dp=dp,
                                        rows_per_sample=hw)),
        "fc2+dp+drop": (lambda: K.gemm(h, w2, b2, residual=r, epilogue="residual", dp=dp,
                                       rows_per_sample=hw, drop=d2),
                        lambda: K.gemm_plain(h, w2, b2, residual=r, epilogue="residual",
                                             dp=dp, rows_per_sample=hw, drop=d2)),
        "fc1+pre": (lambda: (fc1(None), pre[True]),
                    lambda: K.gemm_plain(x, w1, b1, epilogue="gelu")),
        "fc1+pre+drop": (lambda: (fc1(d1), pre[False]),
                         lambda: K.gemm_plain(x, w1, b1, epilogue="gelu", drop=d1)),
        "dx-fc1": (lambda: K.gemm_dgrad(h, w1), lambda: K.gemm_dgrad_plain(h, w1)),
        "dx-proj+dp": (lambda: K.gemm_dgrad(r, wp, dp=dp, rows_per_sample=hw),
                       lambda: K.gemm_dgrad_plain(r, wp, dp=dp, rows_per_sample=hw)),
        "dx-fc2-gelu+dp+drops": (
            lambda: K.gemm_dgrad(r, w2, dp=dp, rows_per_sample=hw, gelu_h=h, drop_dy=d2,
                                 drop_dx=d1),
            lambda: K.gemm_dgrad_plain(r, w2, dp=dp, rows_per_sample=hw, gelu_h=h,
                                       drop_dy=d2, drop_dx=d1)),
    }
    plan = K.gemm_f32_plan
    for name, (kernel, plain) in cases.items():
        outs = []
        for bm, bn in K._F32_TILES:
            monkeypatch.setattr(K, "gemm_f32_plan", lambda M_, N_, kn=False, t=(bm, bn):
                                plan(M_, N_, kn)._replace(bm=t[0], bn=t[1]))
            got = kernel()
            outs.append(got if isinstance(got, tuple) else (got,))
        monkeypatch.setattr(K, "gemm_f32_plan", plan)
        for o in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(o, outs[0])), name
        want = plain()
        assert _rel_l2(outs[0][0], want) <= F32_TOL, name


def test_f32_gemm_smem_is_the_kernels(dev):
    for (bm, bn), kn in itertools.product(K._F32_TILES, (False, True)):
        assert K.library().cswin_gemm_f32_smem(bm, bn, kn) == K.gemm_f32_smem(bm, bn, kn)


def _f32_wgrad_shapes():
    """(H, C, k, n) of the four weight gradients of every training geometry
    of tiny-224 and base-384."""
    return [(H, C, k, n) for H, C, *_ in F32_TRAIN
            for k, n in ((4 * C, C), (C, 4 * C), (C, C), (C, 3 * C))]


@pytest.mark.parametrize("H,C,k,n", _f32_wgrad_shapes())
def test_f32_wgrad_plan_at_the_training_batch(dev, H, C, k, n):
    """At bs 24 (the plan follows M), with the drop-path scale and dY's
    dropout mask: dW and db by the reduction rule against plain, equal bits
    from two calls, one launch each; the plan the wrapper used is
    ``wgrad_f32_plan`` with the card's occupancy."""
    rng = np.random.default_rng(62)
    M, hw = 24 * H * H, H * H
    x, d = _rnd(rng, dev, M, k), _rnd(rng, dev, M, n)
    dp = torch.from_numpy((rng.random(24) < 0.7).astype(np.float32) / 0.7).to(dev)
    _, drop = _drops(dev, 63)
    kw = dict(dp=dp, rows_per_sample=hw, drop=drop)
    before = K.gemm_wgrad.launches_f32
    got, again = K.gemm_wgrad(x, d, **kw), K.gemm_wgrad(x, d, **kw)
    assert K.gemm_wgrad.launches_f32 == before + 2
    plan = K._wgrad_plans[(x.device, M, n, k, torch.float32)]
    fit = lambda bn, bk, cl: K._wgrad_max_clusters(bn, bk, cl, torch.float32)
    assert plan == K.wgrad_f32_plan(M, n, k, fit)
    want = K.gemm_wgrad_plain(x, d, **kw)
    d64 = D.dropout(d * dp.repeat_interleave(hw)[:, None], drop).double()
    for g, a, p, o in zip(got, again, want, (d64.t() @ x.double(), d64.sum(0))):
        assert torch.equal(g, a)
        assert _reduction_ok(g, p, o), (plan, _rel_l2(g, p), _rel_l2(g, o), _rel_l2(p, o))


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


# The lab's branch geometries (tiny-224 stages 1-4, base-384 stages 1-4 as
# block_lab's rows 31-34) and two of no stage: (B, H, W, c, sp_h, sp_w).
LEPE_GEOMETRIES = [(128, 1, 56, 32, 1, 56), (64, 2, 28, 64, 2, 28), (32, 7, 14, 128, 7, 14),
                   (16, 7, 7, 512, 7, 7), (8, 1, 96, 48, 1, 96), (8, 2, 48, 96, 2, 48),
                   (4, 12, 24, 192, 12, 24), (4, 12, 12, 768, 12, 12), (3, 10, 15, 24, 5, 3),
                   (5, 9, 20, 8, 3, 20)]


@pytest.mark.parametrize("geo", LEPE_GEOMETRIES)
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("tap_dtype", [torch.float32, torch.bfloat16])
def test_lepe_windows_plan_is_the_kernels(dev, geo, fold, tap_dtype):
    """``lepe_windows_plan`` with the card's occupancy and SM count is the
    plan the kernel reports for the same geometry."""
    B, H, W, c, sp_h, sp_w = geo
    if fold and c % 16:
        pytest.skip("fold needs an even number of 8-channel chunks")
    got = K.lepe_windows_kernel_plan(*geo, fold=fold, tap_dtype=tap_dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = K.lepe_windows_plan(*geo, fold=fold, ctas_per_sm=got.ctas_per_sm, sms=sms)
    assert got == want and got.ctas_per_sm >= 1 and got.smem_bytes <= K.SMEM_MAX


@pytest.mark.parametrize("n,sp_h,sp_w,c", [(13, 7, 14, 128), (9, 2, 28, 64), (33, 1, 56, 32),
                                           (3, 7, 7, 512), (7, 5, 3, 24), (11, 12, 24, 192)])
def test_lepe_windows_odd_counts(dev, n, sp_h, sp_w, c):
    """Every mode at window counts that leave the last tile's window group
    part empty, and at windows whose rows are no multiple of the walk's 7
    columns: transposed taps, packed V, two tap sets switching inside a
    tile, bf16 taps, two sources with and without the fold."""
    rng = np.random.default_rng(23)
    L = sp_h * sp_w
    qkv = _rnd(rng, dev, n, L, 3 * c).bfloat16()
    v = qkv[..., 2 * c:]
    taps, bias = _rnd(rng, dev, 3, 3, c, sc=0.3), _rnd(rng, dev, c, sc=0.1)
    taps2, bias2 = _rnd(rng, dev, 3, 3, c, sc=0.3), _rnd(rng, dev, c, sc=0.1)
    wide = torch.cat([taps, taps2], -1)
    geo = dict(sp_h=sp_h, sp_w=sp_w)
    for src, t, b, kw in [(v.contiguous(), taps, bias, {}), (v, taps, bias, dict(swap=True)),
                          (v, taps, bias, dict(taps2=taps2, bias2=bias2, n0=n // 2)),
                          (v, taps, bias, dict(tap_dtype=torch.bfloat16)),
                          (v, wide, None, dict(v2=qkv[..., :c])),
                          (v, wide, None, dict(v2=qkv[..., :c], fold=True))]:
        got = K.lepe_windows(src, t, b, **geo, **kw)
        want = K.lepe_windows_plain(src, t, b, **geo, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape, kw
        assert _rel_l2(got.float(), want.float()) <= 0.02, kw


@pytest.mark.parametrize("act,ln,fold", [("gelu", True, False), ("clamp", True, False),
                                         ("gelu", False, False), ("gelu", False, True),
                                         ("clamp", False, True), ("clamp", True, True)])
@pytest.mark.parametrize("rows", [1, 191, 193, 192 * 133 + 5])
def test_ln_mlp_plan_and_odd_rows(dev, act, ln, fold, rows):
    """The plan the kernel reports is ``ln_mlp_plan`` with the card's
    occupancy; each mode at row counts that cut the last 192-row tile and,
    at 133 tiles and more, give a CTA of the one wave a second tile."""
    got_plan = K.ln_mlp_kernel_plan(rows, act, ln, fold)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert got_plan == K.ln_mlp_plan(rows, ctas_per_sm=got_plan.ctas_per_sm, sms=sms)
    rng = np.random.default_rng(24)
    C = 64
    x = _rnd(rng, dev, rows, C).bfloat16()
    nw, nb = _rnd(rng, dev, C, sc=0.3, off=1.0), _rnd(rng, dev, C, sc=0.1)
    w1 = _rnd(rng, dev, 4 * C, C, sc=C ** -0.5).bfloat16()
    w2 = _rnd(rng, dev, C, 4 * C, sc=(4 * C) ** -0.5).bfloat16()
    b1, b2 = _rnd(rng, dev, 4 * C, sc=0.1), _rnd(rng, dev, C, sc=0.1)
    args = (nw, nb, w1, b1) + (() if fold else (w2, b2))
    kw = dict(act=act, ln=ln, fold=fold)
    got = K.ln_mlp(x, *args, **kw)
    want = K.ln_mlp_plain(x, *args, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(got.float(), want.float()) <= 0.02


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
    """The whole-window kernel's shared memory, and past one key block its
    refusal: 0 bytes, and the launch returns cudaErrorInvalidValue before it
    reads a pointer."""
    from cswin_unet_tpu_torch.ops.cuda.build import library

    assert library().cswin_stripe_attention_bwd_smem(L, d) == K.stripe_attention_bwd_smem(L, d)
    if L > 64:
        assert library().cswin_stripe_attention_bwd_smem(L, d) == 0
        assert library().cswin_stripe_attention_bwd(0, 0, 0, 0, 0, 1, L, 1, d, 0, d, 1, L, 1,
                                                    1.0, 0) == 1


@pytest.mark.parametrize("L", [49, 56, 64, 65, 96, 98, 144, 288, 304])
@pytest.mark.parametrize("d", [16, 24, 32])
def test_stripe_attention_bwd_plan_is_the_kernels(dev, L, d):
    from cswin_unet_tpu_torch.ops.cuda.build import library

    plan = K.stripe_attention_bwd_plan(L, d)
    got = tuple(library().cswin_stripe_attention_bwd_plan(L, d, what) for what in range(5))
    assert got[0] == plan.split
    if plan.split:
        assert got[1:] == (plan.rows_smem, plan.keys_smem, plan.row_block,
                           plan.key_tiles_per_cta)
    assert library().cswin_stripe_attention_bwd_plan(L, d, 5) == 0


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
