"""CSWin-UNet forward in PyTorch, NHWC at the public boundary.

Counterpart of ``cswin_unet_tpu.models.cswin_unet``. Submodules carry the
names of the reference torch ``state_dict`` (``stage1.0.attns.1.get_v``,
``upsample2.encoder``, ``output``, ...), so ``torch_to_jax`` of the JAX
package maps this model's weights onto the JAX tree and back
(``utils.checkpoint``).

Routing (``impl="fused"``, as the JAX package's ``attn_impl="fused"`` on its
deterministic path):
  * all 26 blocks run the CSWin block kernel chain (``ops.cuda.cswin_block``),
    except where the stage runner pairs them (``_run_stage``, the JAX
    ``CSWinUNet._run_stage``): in eval mode without gradients, in a
    dual-branch stage (not the last, ``reso != split``) whose geometry
    ``cswin_block.pair_fuse_ok`` accepts, blocks i and i+1 run as one
    ``fused_block_pair`` launch and an odd last block runs alone;
  * the CARAFE upsampler runs the fused CARAFE kernels at stage resolutions
    >= 28 (``upsample2``, 28 -> 56 at 224²) and the plain composition below
    (7 -> 14, 14 -> 28);
  * the x4 tail with the folded classifier runs the fused CARAFE kernels,
    emitting int32 labels directly for ``emit="labels"``.
``impl="pallas"`` (the JAX ``attn_impl="pallas"``) runs every block as the
composition with each stripe branch through the CUDA ``cswin_attention``
kernel (2 launches per dual-branch block, 1 per last-stage block: 50 per
tiny-224 forward), in training too (its gradient is autograd of the
composition, ``CSWinAttentionFn``); CARAFE and the tail run the plain
composition, as in JAX, where the fused CARAFE exists only for ``fused``.
``impl="plain"`` runs the plain PyTorch composition everywhere: the
reference the kernels are held against. The stem, merge convs, standalone
LayerNorms and concat-linears are plain PyTorch ops on both routes.

Training (autograd needs gradients), as the JAX package routes it
(``cswin_unet_tpu/models/cswin_unet.py:141,242-260``): dual-branch blocks at
resolution >= ``FUSE_TRAIN_MIN_RESO`` (stages 1 and 2 at 224²) run the
kernel chain through ``CSWinBlockFn``, whose backward is kernels; the other
blocks run ``composed_block`` under autograd; the fused CARAFE sites train
through their kernel-forward / composition-vjp Functions. Drop-path
(stochastic depth) follows the reference schedule ``linspace(0, rate,
sum(depth))``, shared by encoder and decoder: in train mode each block
draws per-sample keep masks / (1 − p) for its attention and MLP branches
from the ``generator`` passed to ``forward``. With ``use_checkpoint`` (the
config's ``TRAIN.USE_CHECKPOINT``, the JAX package's ``nn.remat`` of each
block) a block keeps no activations for the backward and runs its forward
again there (``torch.utils.checkpoint``); its drop-path multipliers are
drawn before, outside the recomputed region, so both runs use the same
draws. Dropout rates are 0 in every config and are not modelled
(``models.build_model`` refuses another rate).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.carafe import carafe, carafe_with_classifier
from ..ops.cuda.carafe_tail import carafe_tail, carafe_tail_argmax, carafe_up
from ..ops.cuda import cswin_block
from ..ops.cuda.cswin_block import BlockParams, composed_block, fused_cswin_block
from ..ops.cuda.kernels import needs_grad
from ..parallel import rank_rows, world_size

IMPLS = ("fused", "pallas", "plain")
# Smallest stage resolution whose dual-branch blocks train through the
# kernel backward — the JAX package's _FUSE_TRAIN_MIN_RESO, measured on a
# TPU; an H100 measurement of the 14x14 blocks is queued (ROADMAP).
FUSE_TRAIN_MIN_RESO = 28


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, stride: int,
              pad: int) -> torch.Tensor:
    """Conv2d on NHWC in ``x.dtype`` (weights cast), bias added after."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), None, stride, pad)
    y = y.permute(0, 2, 3, 1)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with float32 statistics, out in ``x.dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    y = F.linear(x, lin.weight.to(x.dtype))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (reference Mlp)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class LePEAttention(nn.Module):
    """One stripe branch's parameters: the LePE depthwise 3x3 conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.get_v = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)


class CSWinBlock(nn.Module):
    """LN -> qkv -> two half-channel stripe branches (one full-window branch
    when ``H == split`` or in the last stage) -> proj + residual; LN -> MLP
    + residual."""

    def __init__(self, dim: int, reso: int, num_heads: int, split_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, last_stage: bool = False,
                 impl: str = "fused"):
        super().__init__()
        self.num_heads = num_heads
        self.split_size = split_size
        self.reso = reso
        self.last = last_stage or reso == split_size
        self.impl = impl
        self.drop_path = 0.0
        self.use_checkpoint = False
        self.scale = qk_scale if qk_scale is not None else (dim // num_heads) ** -0.5
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        cb = dim if self.last else dim // 2
        self.attns = nn.ModuleList(LePEAttention(cb)
                                   for _ in range(1 if self.last else 2))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def block_params(self) -> BlockParams:
        a0 = self.attns[0].get_v
        a1 = a0 if self.last else self.attns[1].get_v
        return BlockParams(
            self.norm1.weight, self.norm1.bias, self.qkv.weight, self.qkv.bias,
            a0.weight, a0.bias, a1.weight, a1.bias, self.proj.weight,
            self.proj.bias, self.norm2.weight, self.norm2.bias,
            self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight,
            self.mlp.fc2.bias)

    def drop_path_multipliers(self, batch: int, generator: torch.Generator | None,
                              device: torch.device):
        """Per-sample drop-path multipliers (dp0, dp1), each (batch,) float32
        keep mask / (1 − p), or None outside training or at p = 0."""
        if not self.training or self.drop_path <= 0.0:
            return None
        if generator is None:
            raise ValueError("training with drop-path needs forward(generator=...)")
        keep = 1.0 - self.drop_path
        # Drawn for the global batch and sliced to this rank's rows (one
        # process: the whole draw), so every rank's generator stays equal.
        u = rank_rows(torch.rand((2, world_size() * batch), generator=generator,
                                 device=generator.device), batch, dim=1)
        dp = (u < keep).float().div_(keep).to(device)
        return dp[0], dp[1]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dps = (self.drop_path_multipliers(x.shape[0], generator, x.device)
               if self.training else None)
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(self._block, x, dps, use_reentrant=False)
        return self._block(x, dps)

    def _block(self, x: torch.Tensor, dps) -> torch.Tensor:
        p = self.block_params()
        kw = dict(heads=self.num_heads, split=self.split_size, last_stage=self.last,
                  scale=self.scale, dps=dps)
        if self.impl == "pallas":
            return composed_block(x, p, attn_impl="pallas", **kw)
        if self.impl == "plain" or ((self.last or self.reso < FUSE_TRAIN_MIN_RESO)
                                    and needs_grad(x, *p)):
            return composed_block(x, p, **kw)
        return fused_cswin_block(x, p, **kw)


class MergeBlock(nn.Module):
    """Stage transition: 3x3 stride-2 conv + LN."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim_out, 3, 2, 1)
        self.norm = nn.LayerNorm(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(conv_nhwc(x, self.conv, 2, 1), self.norm)


class CarafeUpsample(nn.Module):
    """CARAFE content-aware upsampler (reference ``CARAFE``): 1x1 down conv
    to C/4, 3x3 encoder conv to 9·up² kernel maps, 1x1 out conv."""

    def __init__(self, dim: int, dim_out: int, up_factor: int = 2):
        super().__init__()
        self.up_factor = up_factor
        self.down = nn.Conv2d(dim, dim // 4, 1)
        self.encoder = nn.Conv2d(dim // 4, up_factor * up_factor * 9, 3, padding=1)
        self.out = nn.Conv2d(dim, dim_out, 1)

    def weights(self) -> tuple[torch.Tensor, ...]:
        return (self.down.weight, self.down.bias, self.encoder.weight,
                self.encoder.bias, self.out.weight, self.out.bias)

    def forward(self, x: torch.Tensor, fused: bool) -> torch.Tensor:
        fn = carafe_up if fused else carafe
        return fn(x, *self.weights(), up_factor=self.up_factor)


class CSWinUNet(nn.Module):
    """The U-Net. Input (B, H, W, in_chans) NHWC; ``emit="logits"`` returns
    float32 (B, H, W, num_classes), ``emit="labels"`` int32 (B, H, W)."""

    def __init__(self, img_size: int = 224, in_chans: int = 3,
                 num_classes: int = 9, embed_dim: int = 64,
                 depth: Sequence[int] = (1, 2, 9, 1),
                 split_size: Sequence[int] = (1, 2, 7, 7),
                 num_heads: Sequence[int] = (2, 4, 8, 16),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, impl: str = "fused",
                 use_checkpoint: bool = False):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.in_chans = in_chans
        self.dtype = dtype
        self.impl = impl
        ed = embed_dim
        self.dims = [ed, ed * 2, ed * 4, ed * 8]
        self.resos = [img_size // (4 * 2**i) for i in range(4)]

        def stage(s):
            return nn.ModuleList(
                CSWinBlock(self.dims[s], self.resos[s], num_heads[s],
                           split_size[s], mlp_ratio, qkv_bias, qk_scale,
                           last_stage=s == 3, impl=impl)
                for _ in range(depth[s]))

        self.stage1_conv_embed = nn.Sequential(
            nn.Conv2d(in_chans, ed, 7, 4, 2), nn.Identity(), nn.LayerNorm(ed))
        for s in range(4):
            setattr(self, f"stage{s + 1}", stage(s))
            if s < 3:
                setattr(self, f"merge{s + 1}", MergeBlock(self.dims[s], self.dims[s + 1]))
        self.norm = nn.LayerNorm(self.dims[3])
        for s in range(3, -1, -1):
            setattr(self, f"stage_up{s + 1}", stage(s))
            if s > 0:
                setattr(self, f"upsample{s + 1}",
                        CarafeUpsample(self.dims[s], self.dims[s - 1]))
                setattr(self, f"concat_linear{s + 1}",
                        nn.Linear(2 * self.dims[s - 1], self.dims[s - 1]))
        self.norm_up = nn.LayerNorm(ed)
        self.upsample1 = CarafeUpsample(ed, ed, up_factor=4)
        self.output = nn.Conv2d(ed, num_classes, 1, bias=False)

        # Stochastic-depth schedule shared by encoder and decoder.
        dpr = np.linspace(0, drop_path_rate, sum(depth))
        offs = [sum(depth[:s]) for s in range(4)]
        for s in range(4):
            for prefix in ("stage", "stage_up"):
                for i, blk in enumerate(getattr(self, f"{prefix}{s + 1}")):
                    blk.drop_path = float(dpr[offs[s] + i])
                    blk.use_checkpoint = use_checkpoint

    def _run_stage(self, blocks: nn.ModuleList, x: torch.Tensor,
                   generator: torch.Generator | None) -> torch.Tensor:
        """Run a stage's blocks, adjacent pairs through one
        ``fused_block_pair`` where the routing allows (module docstring);
        the parameters and ``state_dict`` are the same either way."""
        first = blocks[0]
        pair_ok = (len(blocks) > 1 and self.impl == "fused" and not self.training
                   and not first.last
                   and cswin_block.pair_fuse_ok(first.reso, first.reso, x.shape[-1]))
        i = 0
        while i < len(blocks):
            if pair_ok and i + 1 < len(blocks):
                p1, p2 = blocks[i].block_params(), blocks[i + 1].block_params()
                if not needs_grad(x, *p1, *p2):
                    x = cswin_block.fused_block_pair(
                        x, p1, p2, heads=first.num_heads, split=first.split_size,
                        scale=first.scale)
                    i += 2
                    continue
            x = blocks[i](x, generator)
            i += 1
        return x

    def forward(self, x: torch.Tensor, emit: str = "logits",
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` draws the drop-path masks in train mode."""
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected NHWC input with {self.in_chans} channels, "
                             f"got {tuple(x.shape)}")
        if emit not in ("logits", "labels"):
            raise ValueError(f"unknown emit {emit!r}")
        fused = self.impl == "fused"
        x = x.to(self.dtype)
        conv, _, norm = self.stage1_conv_embed
        x = layer_norm(conv_nhwc(x, conv, 4, 2), norm)

        skips = []
        for s in range(4):
            x = self._run_stage(getattr(self, f"stage{s + 1}"), x, generator)
            if s < 3:
                skips.append(x)
                x = getattr(self, f"merge{s + 1}")(x)
        x = layer_norm(x, self.norm)

        for s in range(3, -1, -1):
            x = self._run_stage(getattr(self, f"stage_up{s + 1}"), x, generator)
            if s > 0:
                up = getattr(self, f"upsample{s + 1}")
                x = up(x, fused=fused and self.resos[s] >= 28)
                x = torch.cat([skips[s - 1], x], dim=-1)
                x = linear(x, getattr(self, f"concat_linear{s + 1}"))
        x = layer_norm(x, self.norm_up)

        tail = (*self.upsample1.weights(), self.output.weight)
        if fused and emit == "labels":
            return carafe_tail_argmax(x, *tail, up_factor=4)
        if fused:
            logits = carafe_tail(x, *tail, up_factor=4)
        else:
            logits = carafe_with_classifier(x, *tail, up_factor=4)
        if emit == "labels":
            return logits.float().argmax(-1).to(torch.int32)
        return logits.float()
