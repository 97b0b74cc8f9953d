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

Activations run in ``dtype`` (the config's ``TPU.COMPUTE_DTYPE``): bf16, or
float32, where every kernel launches its float32 instance and the stock
convolutions (stem, merges, the plain CARAFE sites) run with cuDNN's TF32
off (``ops.precision``), as the JAX package's float32 convolutions are full
float32.

Training (autograd needs gradients): every block on the ``fused`` route,
last-stage blocks included (one full-window branch), runs the kernel chain
through ``CSWinBlockFn``, whose backward is kernels. The JAX package trains
its blocks below resolution 28 and at the last stage as the composition
(``_FUSE_TRAIN_MIN_RESO``, ``cswin_unet_tpu/models/cswin_unet.py:141,
242-260``); the port does not, from its own A/B of the train step on an
H100 (``tools/train_route.py``, cited at ``CSWinBlock._block``). The fused
CARAFE sites train through their kernel-forward / composition-vjp
Functions. Drop-path (stochastic depth) follows the reference schedule ``linspace(0, rate,
sum(depth))``, shared by encoder and decoder: in train mode each block
draws per-sample keep masks / (1 − p) for its attention and MLP branches
from the ``generator`` passed to ``forward``. With ``use_checkpoint`` (the
config's ``TRAIN.USE_CHECKPOINT``, the JAX package's ``nn.remat`` of each
block) a block keeps no activations for the backward and runs its forward
again there (``torch.utils.checkpoint``); its drop-path multipliers and
dropout keys are drawn before, outside the recomputed region, so both runs
use the same draws. Dropout (``drop_rate``, the config's
``MODEL.DROP_RATE``, 0 in every shipped YAML) follows the JAX model's
sites: after the stem's LayerNorm and after each block's GELU and fc2 (in
the encoder and the decoder), flax's ``Dropout`` semantics
(``ops.dropout``). In train mode each site draws one 64-bit key from the
``generator`` a step; the mask is a counter-based function of that key and
the element's global index, so a rank of a data-parallel run draws the bits
one process would for its rows, and ``CSWinBlockFn`` regenerates the masks
in its backward GEMMs instead of keeping them. The stem's dropout is a torch
op; the blocks' are the fc1 and fc2 GEMM epilogues on the ``fused`` route
and the composition's ops on the others.
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
from ..ops.dropout import Drop, draw_keys, dropout
from ..ops.precision import conv2d
from ..parallel import process_shard_info, rank_rows, world_size
from ..utils.profiling import span

IMPLS = ("fused", "pallas", "plain")


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, stride: int,
              pad: int) -> torch.Tensor:
    """Conv2d on NHWC in ``x.dtype`` (weights cast), bias added after; at
    float32 in full float32, forward and backward (``ops.precision.conv2d``:
    cuDNN's TF32 off for each call)."""
    y = conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), None, stride, pad)
    y = y.permute(0, 2, 3, 1)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with float32 statistics, out in ``x.dtype``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


def dropout_keys(n: int, rate: float, x: torch.Tensor,
                 generator: torch.Generator | None) -> tuple[Drop, ...]:
    """``n`` dropout sites over the rows of ``x`` (..., C) for one step:
    keys from ``generator``, each site's first row this rank's offset in
    the global batch."""
    if generator is None:
        raise ValueError("training with dropout needs forward(generator=...)")
    keys = draw_keys(generator, n).to(x.device)
    row0 = process_shard_info()[0] * (x.numel() // x.shape[-1])
    return tuple(Drop(keys[i:i + 1], rate, row0) for i in range(n))


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
        self.drop = 0.0  # MODEL.DROP_RATE: the MLP's dropout
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

    def dropout_sites(self, x: torch.Tensor, generator: torch.Generator | None):
        """The MLP's (fc1, fc2) dropout sites of this step, or None outside
        training or at rate 0."""
        if not self.training or self.drop <= 0.0:
            return None
        return dropout_keys(2, self.drop, x, generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dps = (self.drop_path_multipliers(x.shape[0], generator, x.device)
               if self.training else None)
        drops = self.dropout_sites(x, generator)
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(self._block, x, dps, drops, use_reentrant=False)
        return self._block(x, dps, drops)

    def _block(self, x: torch.Tensor, dps, drops=None) -> torch.Tensor:
        # Training runs every geometry through CSWinBlockFn. On an NVIDIA H100
        # 80GB HBM3 at 700.00 W, tools/train_route.py --rounds 4 (the bs-24
        # recipe step, all blocks through it against one geometry's blocks
        # composed; ms median [min-max] in forward / reverse order; peak GiB)
        # found no geometry faster composed:
        #   tiny-224, all through it 99.2 [87.9-113.3] / 108.4 [91.7-122.5],
        #   2.78 GiB. Composed: 56x56x64 114.0 / 114.8, 3.37; 28x28x128 124.8
        #   / 134.5, 3.37; 14x14x256 211.4 / 227.8, 4.37 (slower beyond the
        #   spread); 7x7x512 (last) 106.0 / 105.0, 2.87.
        #   base-384, all through it 305.3 [293.3-350.2] / 296.6 [289.9-
        #   298.2], 21.89 GiB. Composed: 96x96x96 348.4 / 354.5, 28.57;
        #   48x48x192 362.2 / 378.4, 28.57 and 24x24x384 823.9 / 832.2, 69.39
        #   (both slower beyond the spread); 12x12x768 (last) 312.7 / 313.9,
        #   22.98.
        # The others lie inside the spread and take more memory composed.
        # The JAX package's _FUSE_TRAIN_MIN_RESO (14x14 and the last stage
        # composed) came from another device's timing.
        p = self.block_params()
        kw = dict(heads=self.num_heads, split=self.split_size, last_stage=self.last,
                  scale=self.scale, dps=dps, drops=drops)
        if self.impl == "pallas":
            return composed_block(x, p, attn_impl="pallas", **kw)
        if self.impl == "plain":
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
                 use_checkpoint: bool = False, drop_rate: float = 0.0):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if not 0.0 <= drop_rate <= 1.0:
            raise ValueError(f"drop_rate must lie in [0, 1], got {drop_rate}")
        self.drop_rate = drop_rate
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
                    blk.drop = drop_rate
                    blk.use_checkpoint = use_checkpoint

    def _run_stage(self, blocks: nn.ModuleList, x: torch.Tensor,
                   generator: torch.Generator | None) -> torch.Tensor:
        """Run a stage's blocks, adjacent pairs through one
        ``fused_block_pair`` where the routing allows (module docstring);
        the parameters and ``state_dict`` are the same either way."""
        first = blocks[0]
        pair_ok = (len(blocks) > 1 and self.impl == "fused" and not self.training
                   and not first.last
                   and cswin_block.pair_fuse_ok(first.reso, first.reso, x.shape[-1],
                                                x.dtype))
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
        """``generator`` draws the drop-path masks and dropout keys in train
        mode."""
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected NHWC input with {self.in_chans} channels, "
                             f"got {tuple(x.shape)}")
        if emit not in ("logits", "labels"):
            raise ValueError(f"unknown emit {emit!r}")
        fused = self.impl == "fused"
        x = x.to(self.dtype)
        conv, _, norm = self.stage1_conv_embed
        x = layer_norm(conv_nhwc(x, conv, 4, 2), norm)
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, dropout_keys(1, self.drop_rate, x, generator)[0])

        skips = []
        for s in range(4):
            with span(f"model.stage{s + 1}"):
                x = self._run_stage(getattr(self, f"stage{s + 1}"), x, generator)
            if s < 3:
                skips.append(x)
                x = getattr(self, f"merge{s + 1}")(x)
        x = layer_norm(x, self.norm)

        for s in range(3, -1, -1):
            with span(f"model.stage_up{s + 1}"):
                x = self._run_stage(getattr(self, f"stage_up{s + 1}"), x, generator)
            if s > 0:
                up = getattr(self, f"upsample{s + 1}")
                x = up(x, fused=fused and self.resos[s] >= 28)
                x = torch.cat([skips[s - 1], x], dim=-1)
                x = linear(x, getattr(self, f"concat_linear{s + 1}"))
        x = layer_norm(x, self.norm_up)

        with span("model.tail"):
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
