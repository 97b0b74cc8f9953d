"""Full float32 convolutions where the activations are float32.

On the card a float32 convolution goes through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits of each operand; the JAX package's float32 convolutions are
full float32. ``conv_precision(dtype)`` switches TF32 off for the calls made
inside it when ``dtype`` is float32, and leaves the flags alone otherwise, so
the bf16 route does not change. The flag is scoped to the call: no entry
point sets it for the process.

A context around the forward call does not reach its backward: autograd
runs a convolution's backward later (in ``loss.backward()`` or
``torch.autograd.grad``, or inside a Function's backward that re-runs a
composition), and ``convolution_backward`` reads the global flag then.
``conv2d`` is the model's convolution: at float32 its forward and its
backward run under ``conv_precision``, wherever autograd runs the latter;
at other dtypes it is ``F.conv2d``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def conv_precision(dtype: torch.dtype):
    """A context for convolutions on activations of ``dtype``: cuDNN's
    TF32 off at float32 (the other cuDNN flags as they are), nothing
    otherwise."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` at float32 whose forward and backward both run under
    ``conv_precision``. The backward is aten's ``convolution_backward`` of
    the saved input and weight, the op autograd itself would run."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, groups, bias is not None)
        with conv_precision(torch.float32):
            return F.conv2d(x, weight, bias, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        stride, padding, groups, has_bias = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        pair = lambda v: [v, v] if isinstance(v, int) else list(v)
        with conv_precision(torch.float32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                gy, x, weight, [weight.shape[0]] if has_bias else None, pair(stride),
                pair(padding), [1, 1], False, [0, 0], groups,
                [need_x, need_w, has_bias and need_b])
        return gx, gw, gb if has_bias else None, None, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0, groups: int = 1, *,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """``F.conv2d`` (NCHW) for activations of ``dtype`` (by default
    ``x.dtype``; a caller that upcasts its operands first passes the
    activations' own): at float32 in full float32, forward and backward
    (cuDNN's TF32 off, scoped to each call); ``F.conv2d`` as it is
    otherwise."""
    if (x.dtype if dtype is None else dtype) != torch.float32:
        return F.conv2d(x, weight, bias, stride, padding, 1, groups)
    return _Conv2dF32.apply(x, weight, bias, stride, padding, groups)
