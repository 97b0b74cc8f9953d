"""The CSWin block, forward and backward, as chains of hand-written CUDA
kernels.

Counterpart of ``cswin_unet_tpu/ops/pallas/cswin_block.py``: the TPU ran a
whole block per image in one Pallas program (``fused_cswin_block``); an H100
block of threads has 227 KB of shared memory, so here the block is a chain:

  LN1 (layernorm) -> qkv (gemm, bias) -> stripe attention + LePE per branch,
  written at the branch's channel offset -> proj (gemm, bias + residual) ->
  LN2 -> fc1 (gemm, bias + erf GELU) -> fc2 (gemm, bias + residual)

with per-sample drop-path multipliers in the two residual epilogues and,
in training at ``MODEL.DROP_RATE`` > 0, the MLP's two dropout masks (the
fc1 site after the GELU, the fc2 site before drop-path) in the fc1 and fc2
epilogues. The
backward (``CSWinBlockFn``, counterpart of ``_fused_block_bwd_xt``) runs

  fc2 dX with the GELU backward (gemm_dgrad, both dropout masks) and wgrad
  (the fc2 site's mask on dY) -> fc1 wgrad and dX
  -> LN2 backward + residual -> proj wgrad and dX -> attention + LePE
  backward per branch into one dqkv -> qkv wgrad and dX -> LN1 backward +
  residual

Channels ``[:C/2]`` are the vertical branch (windows ``H x split``,
``attns.0``), ``[C/2:]`` the horizontal one (``split x W``, ``attns.1``). A
last-stage block (``H == split``) runs one branch over the full window with
all heads. ``scale`` is ``(C // heads) ** -0.5`` over the whole block.

``fused_block_pair`` runs two consecutive dual-branch blocks of one stage
through one launch of the ``block_pair`` kernel (inference only), the
counterpart of ``_fused_block_pair_fwd``; ``pair_fuse_ok`` says where the
model's stage runner takes it.

``composed_block`` is the plain PyTorch version of the same function, with
the rounding points of the JAX ``composed_block``. With
``attn_impl="pallas"`` it is the ``pallas`` route's block: the same
composition with each branch through the CUDA ``cswin_attention`` kernel
(``ops.cuda.cswin_attention``), as the JAX block runs
``cswin_attention_pallas`` per branch under ``attn_impl="pallas"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..attention import cswin_attention
from ..dropout import Drop, dropout
from .kernels import (block_pair, gemm, gemm_dgrad, gemm_wgrad, layernorm,
                      layernorm_bwd, needs_grad, stripe_attention,
                      stripe_attention_bwd)


class BlockParams(NamedTuple):
    """One block's parameters in torch layouts (Linear (out, in), LePE
    (cb, 1, 3, 3)), in the order of the JAX fused kernel's 16-tuple. A
    last-stage block passes its single LePE in both slots."""

    norm1_w: torch.Tensor
    norm1_b: torch.Tensor
    qkv_w: torch.Tensor
    qkv_b: torch.Tensor | None
    lepe0_w: torch.Tensor
    lepe0_b: torch.Tensor
    lepe1_w: torch.Tensor
    lepe1_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    norm2_w: torch.Tensor
    norm2_b: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor


def _chain(x: torch.Tensor, p: BlockParams, dps, drops, *, heads: int, split: int,
           last_stage: bool, scale: float, keep: bool):
    """The forward kernel chain. Returns (out, saved): ``saved`` holds what
    the backward reads (None unless ``keep``); with ``keep`` the fc1 GEMM
    also writes its rounded pre-activation h for the GELU backward.
    ``drops``: None or the (fc1, fc2) dropout sites, masked in those GEMMs'
    epilogues."""
    B, H, W, C = x.shape
    dt = x.dtype
    hw = H * W
    dp0, dp1 = (None, None) if dps is None else (
        d.to(dt).float().contiguous() for d in dps)
    rows = x.reshape(B * H * W, C).contiguous()
    xn = layernorm(rows, p.norm1_w, p.norm1_b)
    qkv = gemm(xn, p.qkv_w.to(dt), p.qkv_b).view(B, H, W, 3 * C)
    att = torch.empty((B, H, W, C), dtype=dt, device=x.device)
    for off, cb, nh, hs, ws, lw, lb in _branches(p, H, W, C, heads, split,
                                                 last_stage):
        stripe_attention(qkv, lw, lb, att, ch_off=off, heads=nh, h_sp=hs,
                         w_sp=ws, scale=scale)
    att = att.view(B * H * W, C)
    x1 = gemm(att, p.proj_w.to(dt), p.proj_b, residual=rows,
              epilogue="residual", dp=dp0, rows_per_sample=hw)
    y = layernorm(x1, p.norm2_w, p.norm2_b)
    h = (torch.empty((B * H * W, p.fc1_w.shape[0]), dtype=dt, device=x.device)
         if keep else None)
    d1, d2 = drops or (None, None)
    g = gemm(y, p.fc1_w.to(dt), p.fc1_b, epilogue="gelu", pre=h, drop=d1)
    out = gemm(g, p.fc2_w.to(dt), p.fc2_b, residual=x1, epilogue="residual",
               dp=dp1, rows_per_sample=hw, drop=d2)
    saved = (rows, xn, qkv, att, x1, y, h, g, dp0, dp1) if keep else None
    return out.view(B, H, W, C), saved


def _branches(p: BlockParams, H, W, C, heads, split, last_stage):
    """(channel offset, width, heads, h_sp, w_sp, LePE weight, LePE bias) of
    each stripe branch."""
    if last_stage:
        return [(0, C, heads, H, W, p.lepe0_w, p.lepe0_b)]
    half = C // 2
    return [(0, half, heads // 2, H, split, p.lepe0_w, p.lepe0_b),
            (half, half, heads // 2, split, W, p.lepe1_w, p.lepe1_b)]


class CSWinBlockFn(torch.autograd.Function):
    """The block with a hand-written backward: the forward kernel chain
    (drop-path in the residual epilogues), and a backward chain of CUDA
    kernels in the order and with the rounding points of the JAX
    ``_block_bwd_kernel_xt`` (cswin_block.py:1677-1785): cotangents rounded
    to the activation dtype before each product, accumulation and LN
    statistics in float32.

    Saved for the backward: the block input, LN1 out, qkv (3C), attention
    out, x1, LN2 out, fc1 pre-activation h (4C) and GELU out (4C, after the
    fc1 site's dropout) — 16·M·C values for M rows, 32·M·C bytes in bf16
    and 64·M·C at float32. At bs 24: tiny-224's stages 1-4 154, 77, 38.5
    and 19.3 MB a block in bf16 (308, 154, 77 and 38.5 at float32);
    base-384's 679, 340, 170 and 85 MB (1359, 679, 340 and 170). All but h
    are the forward chain's own outputs, kept instead of recomputed; no
    L x L score is kept (the attention backward recomputes its
    probabilities). Dropout adds nothing of size M x C: the backward GEMMs
    regenerate both masks from the sites' keys (two int64 a block).

    At float32 (``TPU.COMPUTE_DTYPE float32``) every step launches its
    kernel's float32 instance and nothing in the backward chain is
    rounded: the cotangents stay float32, the drop-path multipliers are
    the float32 ones.

    A last-stage block (``last_stage``) runs one branch over the whole
    window with every head: its LePE is passed in both slots and its
    gradient returned in the first (autograd sums the two).
    """

    @staticmethod
    def forward(ctx, x, dp0, dp1, drops, heads, split, last_stage, scale, *params):
        p = BlockParams(*params)
        kw = dict(heads=heads, split=split, last_stage=last_stage, scale=scale)
        dps = None if dp0 is None else (dp0, dp1)
        out, saved = _chain(x, p, dps, drops, keep=True, **kw)
        ctx.save_for_backward(*saved, *params)
        ctx.kw = kw
        ctx.drops = drops
        return out

    @staticmethod
    def backward(ctx, gout):
        rows, xn, qkv, att, x1, y, h, g, dp0, dp1, *params = ctx.saved_tensors
        p = BlockParams(*params)
        kw = ctx.kw
        B, H, W, C3 = qkv.shape
        C = C3 // 3
        hw = H * W
        dt = rows.dtype
        do = gout.reshape(B * H * W, C).to(dt).contiguous()

        # MLP and the second residual (drop-path dp1, dropout d2 and d1)
        d1, d2 = ctx.drops or (None, None)
        dh = gemm_dgrad(do, p.fc2_w, dp=dp1, rows_per_sample=hw, gelu_h=h, drop_dy=d2,
                        drop_dx=d1)
        dfc2_w, dfc2_b = gemm_wgrad(g, do, dp=dp1, rows_per_sample=hw, drop=d2)
        dfc1_w, dfc1_b = gemm_wgrad(y, dh)
        dy = gemm_dgrad(dh, p.fc1_w)
        dx1, dn2_w, dn2_b = layernorm_bwd(x1, dy, p.norm2_w, residual=do)
        # proj and the first residual (drop-path dp0)
        dproj_w, dproj_b = gemm_wgrad(att, dx1, dp=dp0, rows_per_sample=hw)
        datt = gemm_dgrad(dx1, p.proj_w, dp=dp0, rows_per_sample=hw)
        # attention + LePE, both branches into one dqkv buffer
        dqkv = torch.empty_like(qkv)
        dlepe = []
        for off, cb, nh, hs, ws, lw, _ in _branches(
                p, H, W, C, kw["heads"], kw["split"], kw["last_stage"]):
            dlepe.append(stripe_attention_bwd(
                qkv, datt.view(B, H, W, C), lw, dqkv, ch_off=off, heads=nh,
                h_sp=hs, w_sp=ws, scale=kw["scale"]))
        dqkv = dqkv.view(B * H * W, C3)
        dqkv_w, dqkv_b = gemm_wgrad(xn, dqkv)
        dxn = gemm_dgrad(dqkv, p.qkv_w)
        dx, dn1_w, dn1_b = layernorm_bwd(rows, dxn, p.norm1_w, residual=dx1)

        (dl0_w, dl0_b), (dl1_w, dl1_b) = (dlepe if len(dlepe) == 2
                                          else (dlepe[0], (None, None)))
        grads = BlockParams(
            dn1_w, dn1_b, dqkv_w, None if p.qkv_b is None else dqkv_b,
            dl0_w, dl0_b, dl1_w, dl1_b, dproj_w, dproj_b, dn2_w, dn2_b,
            dfc1_w, dfc1_b, dfc2_w, dfc2_b)
        return (dx.view(B, H, W, C), None, None, None, None, None, None, None,
                *grads)


def fused_cswin_block(x: torch.Tensor, p: BlockParams, *, heads: int,
                      split: int, last_stage: bool, scale: float,
                      dps: tuple[torch.Tensor, torch.Tensor] | None = None,
                      drops: tuple[Drop, Drop] | None = None) -> torch.Tensor:
    """Block forward (B, H, W, C) -> (B, H, W, C) through the kernel chain.

    ``dps``: None, or per-sample drop-path multipliers (dp0, dp1), each (B,)
    float32 (keep mask / (1 − p)), applied in the activation dtype to the
    attention and MLP branches before their residual adds. ``drops``: None,
    or the MLP's dropout sites (after the GELU, after fc2), over the rows
    (b, h, w) of this call. On a CUDA tensor
    every step is a CUDA kernel (the bf16 or float32 instance, by the
    activations' dtype); on a CPU tensor each step runs that kernel's plain
    version. Where autograd needs gradients,
    the call goes through ``CSWinBlockFn``, whose backward is kernels too.
    """
    if needs_grad(x, *p):
        dp0, dp1 = (None, None) if dps is None else dps
        return CSWinBlockFn.apply(x, dp0, dp1, drops, heads, split, last_stage, scale,
                                  *p)
    return _chain(x, p, dps, drops, heads=heads, split=split, last_stage=last_stage,
                  scale=scale, keep=False)[0]


# (H, W, C, activations' dtype) geometries whose adjacent blocks the stage
# runner pairs: those where one block_pair launch beats two block chains on
# an H100 at B = 32 by more than the spread in both orders (the [pair] A/B
# of chip_smoke.py, tile_ab.py --phases at float32). 14x14x256, tiny-224's
# stage 3, bf16: on the tensor-core tiles the pair (0.51-0.72 ms a pair of
# blocks) beat the chain (0.67-1.22) beyond the spread in three of four
# runs, and by 0.16-0.20 ms inside a wider spread in the fourth. Not at
# float32: the float32 pair on the chain's GEMM tile at 3 CTAs an SM reads
# 0.95 ms a pair against 0.79 for two float32 chains, each phase slower
# than the chain's kernel (PERF.md, the float32 pair). Not 28x28x128, stage 2: the pair
# (0.57-0.63 ms) beat the chain in two runs (0.83-1.07) and lost in two
# (0.48-0.54); the chain's time at B = 32 is mostly its 16 launches' host
# work. Both lose at B = 128. The JAX package's _pair_fuse_ok is off
# everywhere, from a TPU measurement that does not carry over.
PAIR_GEOMETRIES: frozenset[tuple[int, int, int, str]] = frozenset({(14, 14, 256, "bfloat16")})


def pair_fuse_ok(H: int, W: int, C: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the stage runner fuses adjacent blocks of this geometry into
    one ``fused_block_pair`` at activations of ``dtype`` (counterpart of
    ``_pair_fuse_ok``)."""
    return (H, W, C, str(dtype).removeprefix("torch.")) in PAIR_GEOMETRIES


def fused_block_pair(x: torch.Tensor, p1: BlockParams, p2: BlockParams, *,
                     heads: int, split: int, scale: float) -> torch.Tensor:
    """Two consecutive dual-branch blocks of one geometry, (B, H, W, C) ->
    (B, H, W, C), in one ``block_pair`` launch: equal to two
    ``fused_cswin_block`` calls. Inference only, as the JAX pair: there is
    no backward, so a call that autograd would differentiate raises."""
    if needs_grad(x, *p1, *p2):
        raise ValueError("fused_block_pair has no backward: call it without "
                         "gradients (torch.inference_mode) or run two blocks")
    return block_pair(x, p1, p2, heads=heads, split=split, scale=scale)


def composed_block(x: torch.Tensor, p: BlockParams, *, heads: int, split: int,
                   last_stage: bool, scale: float,
                   dps: tuple[torch.Tensor, torch.Tensor] | None = None,
                   attn_impl: str = "xla",
                   drops: tuple[Drop, Drop] | None = None) -> torch.Tensor:
    """Plain PyTorch composition of the same block (the kernel chain's
    reference, differentiable by autograd): float32 LN statistics, products
    accumulated in float32 and rounded to ``x.dtype`` after the bias, exact
    erf GELU on the rounded fc1 output, dropout (``drops``: flax's
    ``round(v / keep)`` on the rounded GELU and fc2 outputs), drop-path
    multipliers and residual adds in ``x.dtype``. ``attn_impl`` picks each branch's attention
    (``ops.attention.cswin_attention``): the composition (``"xla"``) or the
    ``cswin_attention`` kernel (``"pallas"``)."""
    B, H, W, C = x.shape
    dt = x.dtype

    def ln(t, w, b):
        tf = t.float()
        mu = tf.mean(-1, keepdim=True)
        var = ((tf - mu) ** 2).mean(-1, keepdim=True)
        return ((tf - mu) * torch.rsqrt(var + 1e-5) * w + b).to(dt)

    def linear(t, w, b):
        acc = t.reshape(-1, t.shape[-1]).float() @ w.to(dt).float().t()
        return acc if b is None else acc + b

    xn = ln(x, p.norm1_w, p.norm1_b)
    qkv = linear(xn, p.qkv_w, p.qkv_b).to(dt).reshape(B, H, W, 3, C)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

    def attn(qq, kk, vv, lw, lb, h_sp, w_sp, nh):
        return cswin_attention(qq, kk, vv, lw, lb, h_sp=h_sp, w_sp=w_sp,
                               num_heads=nh, scale=scale, impl=attn_impl)

    if last_stage:
        att = attn(q, k, v, p.lepe0_w, p.lepe0_b, H, W, heads)
    else:
        half = C // 2
        a0 = attn(q[..., :half], k[..., :half], v[..., :half], p.lepe0_w,
                  p.lepe0_b, H, split, heads // 2)
        a1 = attn(q[..., half:], k[..., half:], v[..., half:], p.lepe1_w,
                  p.lepe1_b, split, W, heads // 2)
        att = torch.cat([a0, a1], dim=-1)

    att = linear(att, p.proj_w, p.proj_b).to(dt).reshape(B, H, W, C)
    if dps is not None:
        att = att * dps[0].to(dt)[:, None, None, None]
    x1 = x + att
    y = ln(x1, p.norm2_w, p.norm2_b)
    y = linear(y, p.fc1_w, p.fc1_b).to(dt)
    d1, d2 = drops or (None, None)
    y = dropout(F.gelu(y.float()).to(dt), d1)
    y = dropout(linear(y, p.fc2_w, p.fc2_b).to(dt), d2).reshape(B, H, W, C)
    if dps is not None:
        y = y * dps[1].to(dt)[:, None, None, None]
    return x1 + y
