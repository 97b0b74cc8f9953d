"""Fused CARAFE through hand-written CUDA kernels.

Counterpart of ``cswin_unet_tpu/ops/pallas/carafe_tail.py``. ``carafe_fused``
runs the whole CARAFE upsampler as two kernels:

  1. one GEMM of x against [W_down ; W_y ; 0] (bias [b_down ; 0]) gives the
     1x1 down conv ``mid`` and the classes-before-reassembly ``y`` together,
     padded with zero channels to a multiple of 8 (``gy_channels``);
  2. the CARAFE kernel runs the 3x3 encoder conv, the softmax over the 9
     taps of each up-position and the 9-tap reassembly, and writes bf16
     logits with the depth-to-space done, or int32 labels.

For the model's tail ``W_y = W_cls · W_out`` and the bias is
``W_cls · b_out``: both 1x1 convs commute below the reassembly, which is
exact because the taps sum to 1 (see ``ops.carafe.carafe_with_classifier``).
Without a classifier ``W_y = W_out`` and the bias is ``b_out``.

Each public function has its plain PyTorch version beside it.

Training: ``carafe_up`` and ``carafe_tail`` are differentiable through
``CarafeFn``, as the JAX ``custom_vjp`` pair
(``cswin_unet_tpu/ops/pallas/carafe_tail.py:295-399``): the forward is the
kernels, the backward re-runs the plain composition (``ops.carafe``) under
autograd and takes its vjp.
"""

from __future__ import annotations

import torch

from ..carafe import carafe, carafe_with_classifier
from .kernels import carafe_reassemble, gemm, needs_grad


def gy_channels(c_mid: int, nc: int) -> int:
    """Channels of the (down | classes) GEMM's output: ``c_mid + nc``
    rounded up to a multiple of 8, so that the CARAFE kernel loads a pixel
    in 16-byte copies and the GEMM stores whole 16-byte chunks (the tail's
    16 + 9 become 32). The padding channels are zero and reach no output."""
    return -(-(c_mid + nc) // 8) * 8


def carafe_fused(x: torch.Tensor, down_weight: torch.Tensor,
                 down_bias: torch.Tensor, encoder_weight: torch.Tensor,
                 encoder_bias: torch.Tensor, out_weight: torch.Tensor,
                 out_bias: torch.Tensor, cls_weight: torch.Tensor | None = None,
                 *, up_factor: int = 2, emit: str = "logits") -> torch.Tensor:
    """Whole CARAFE (B, H, W, C) -> (B, up·H, up·W, NC) logits in
    ``x.dtype``, or (B, up·H, up·W) int32 labels with ``emit="argmax"``.

    Weights in torch layouts: down (C/4, C, 1, 1), encoder (9·up², C/4, 3,
    3), out (C_out, C, 1, 1), classifier (NC, C_out, 1, 1) or None.
    """
    if emit not in ("logits", "argmax"):
        raise ValueError(f"unknown emit {emit!r}")
    B, H, W, C = x.shape
    c_mid = down_weight.shape[0]
    w_out = out_weight[:, :, 0, 0].float()                  # (C_out, C)
    if cls_weight is not None:
        w_cls = cls_weight[:, :, 0, 0].float()              # (NC, C_out)
        w_y = w_cls @ w_out                                  # (NC, C)
        bias = w_cls @ out_bias.float()                      # (NC,)
    else:
        w_y, bias = w_out, out_bias.float()
    pad = gy_channels(c_mid, w_y.shape[0]) - c_mid - w_y.shape[0]
    w_cat = torch.cat([down_weight[:, :, 0, 0].float(), w_y,
                       w_y.new_zeros(pad, C)]).to(x.dtype)
    b_cat = torch.cat([down_bias.float(), bias.new_zeros(bias.shape[0] + pad)])
    gy = gemm(x.reshape(B * H * W, C).contiguous(), w_cat.contiguous(), b_cat)
    return carafe_reassemble(gy.view(B, H, W, -1), encoder_weight, encoder_bias,
                             bias.contiguous(), c_mid=c_mid, up=up_factor,
                             labels=emit == "argmax")


class CarafeFn(torch.autograd.Function):
    """A fused CARAFE site: the kernel forward (``carafe_fused``), and as
    backward the vjp of ``plain``, its composition (``ops.carafe.carafe`` or
    ``carafe_with_classifier``), re-run under autograd on the saved inputs."""

    @staticmethod
    def forward(ctx, plain, up_factor, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.plain, ctx.up_factor = plain, up_factor
        return carafe_fused(*inputs, up_factor=up_factor)

    @staticmethod
    def backward(ctx, grad):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain(*leaves, up_factor=ctx.up_factor)
        return (None, None, *torch.autograd.grad(out, leaves, grad))


def carafe_up(x, down_weight, down_bias, encoder_weight, encoder_bias,
              out_weight, out_bias, up_factor: int = 2) -> torch.Tensor:
    """CARAFE upsampler between decoder stages (no classifier)."""
    inputs = (x, down_weight, down_bias, encoder_weight, encoder_bias,
              out_weight, out_bias)
    if needs_grad(*inputs):
        return CarafeFn.apply(carafe, up_factor, *inputs)
    return carafe_fused(*inputs, up_factor=up_factor)


def carafe_up_plain(x, down_weight, down_bias, encoder_weight, encoder_bias,
                    out_weight, out_bias, up_factor: int = 2) -> torch.Tensor:
    return carafe(x, down_weight, down_bias, encoder_weight, encoder_bias,
                  out_weight, out_bias, up_factor=up_factor)


def carafe_tail(x, down_weight, down_bias, encoder_weight, encoder_bias,
                out_weight, out_bias, cls_weight,
                up_factor: int = 4) -> torch.Tensor:
    """The model tail: x4 CARAFE with the classifier folded in -> logits."""
    inputs = (x, down_weight, down_bias, encoder_weight, encoder_bias,
              out_weight, out_bias, cls_weight)
    if needs_grad(*inputs):
        return CarafeFn.apply(carafe_with_classifier, up_factor, *inputs)
    return carafe_fused(*inputs, up_factor=up_factor)


def carafe_tail_plain(x, down_weight, down_bias, encoder_weight, encoder_bias,
                      out_weight, out_bias, cls_weight,
                      up_factor: int = 4) -> torch.Tensor:
    return carafe_with_classifier(x, down_weight, down_bias, encoder_weight,
                                  encoder_bias, out_weight, out_bias,
                                  cls_weight, up_factor=up_factor)


def carafe_tail_argmax(x, down_weight, down_bias, encoder_weight,
                       encoder_bias, out_weight, out_bias, cls_weight,
                       up_factor: int = 4) -> torch.Tensor:
    """The eval tail: int32 labels, the per-pixel argmax fused in (softmax
    is monotone, so this equals softmax then argmax)."""
    return carafe_fused(x, down_weight, down_bias, encoder_weight, encoder_bias,
                        out_weight, out_bias, cls_weight, up_factor=up_factor,
                        emit="argmax")


def carafe_tail_argmax_plain(x, down_weight, down_bias, encoder_weight,
                             encoder_bias, out_weight, out_bias, cls_weight,
                             up_factor: int = 4) -> torch.Tensor:
    logits = carafe_tail_plain(x, down_weight, down_bias, encoder_weight,
                               encoder_bias, out_weight, out_bias, cls_weight,
                               up_factor=up_factor)
    return logits.float().argmax(-1).to(torch.int32)
