"""CARAFE content-aware upsampling, plain PyTorch on NHWC tensors.

Counterpart of ``cswin_unet_tpu.ops.carafe`` (the ``fast`` formulation and
``carafe_with_classifier``). Weights are in torch layouts: 1x1 and 3x3 convs
are OIHW. The encoder's output channels are k²-major, ``o = tap·up² + s``;
taps are row-major ``(di, dj)`` over the 3x3 neighbourhood; the output
depth-to-space puts up-position ``s = i·up + j`` at ``(h·up + i, w·up + j)``.

These are the plain versions that the fused CUDA CARAFE kernel
(``ops.cuda.carafe_tail``) is held against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import conv2d


def _conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          pad: int) -> torch.Tensor:
    """NHWC conv in ``x.dtype`` (weights cast to it), bias added after; at
    float32 in full float32, forward and backward (cuDNN's TF32 off for
    each call, ``ops.precision.conv2d``)."""
    y = conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=pad)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(x.dtype)


def extract_patches_3x3(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C, k²) zero-padded neighbourhoods, taps
    row-major over (di, dj)."""
    k = kernel_size
    p = k // 2
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, p, p, p, p))
    taps = [xp[:, di:di + H, dj:dj + W, :] for di in range(k) for dj in range(k)]
    return torch.stack(taps, dim=-1)


def _kernels(x, down_weight, down_bias, encoder_weight, encoder_bias,
             kernel_size, up_factor):
    """Kernel prediction: 1x1 down conv, 3x3 encoder conv, softmax over the
    k² taps of each up-position (float32) -> (B, H, W, k², up²)."""
    B, H, W, _ = x.shape
    enc = _conv(_conv(x, down_weight, down_bias, 0), encoder_weight,
                encoder_bias, kernel_size // 2)
    kern = enc.reshape(B, H, W, kernel_size * kernel_size, up_factor * up_factor)
    return torch.softmax(kern.float(), dim=3).to(x.dtype)


def _depth_to_space(t: torch.Tensor, up: int) -> torch.Tensor:
    """(B, H, W, C, up²) -> (B, up·H, up·W, C)."""
    B, H, W, C, _ = t.shape
    t = t.reshape(B, H, W, C, up, up).permute(0, 1, 4, 2, 5, 3)
    return t.reshape(B, H * up, W * up, C)


def carafe(x: torch.Tensor, down_weight: torch.Tensor, down_bias: torch.Tensor,
           encoder_weight: torch.Tensor, encoder_bias: torch.Tensor,
           out_weight: torch.Tensor, out_bias: torch.Tensor, *,
           kernel_size: int = 3, up_factor: int = 2) -> torch.Tensor:
    """CARAFE upsample (B, H, W, C) -> (B, up·H, up·W, C_out).

    The JAX ``fast`` formulation: the 1x1 out conv's weight runs before
    reassembly (it commutes with it), its bias after.
    """
    kern = _kernels(x, down_weight, down_bias, encoder_weight, encoder_bias,
                    kernel_size, up_factor)
    y = _conv(x, out_weight, None, 0)                     # (B, H, W, C_out)
    patches = extract_patches_3x3(y, kernel_size)         # (B, H, W, C_out, k²)
    out = torch.einsum("bhwck,bhwks->bhwcs", patches.float(), kern.float())
    out = (out + out_bias.float()[:, None]).to(x.dtype)
    return _depth_to_space(out, up_factor)


def carafe_with_classifier(x: torch.Tensor, down_weight: torch.Tensor,
                           down_bias: torch.Tensor,
                           encoder_weight: torch.Tensor,
                           encoder_bias: torch.Tensor, out_weight: torch.Tensor,
                           out_bias: torch.Tensor, cls_weight: torch.Tensor, *,
                           kernel_size: int = 3,
                           up_factor: int = 4) -> torch.Tensor:
    """CARAFE upsample then a bias-free 1x1 classifier, fused exactly:
    ``logits = reassemble(x · W_out) · W_cls + b_out · W_cls``.

    Exact because the softmaxed taps sum to 1 and reassembly weights are
    per-pixel scalars shared by all channels (see the JAX docstring).
    Returns (B, up·H, up·W, NC) in ``x.dtype``.
    """
    kern = _kernels(x, down_weight, down_bias, encoder_weight, encoder_bias,
                    kernel_size, up_factor)
    w_cls = cls_weight[:, :, 0, 0].float().t()            # (C, NC)
    bias_comb = out_bias.float() @ w_cls                  # (NC,)
    y = _conv(x, out_weight, None, 0)                     # (B, H, W, C)
    patches = extract_patches_3x3(y, kernel_size)         # (B, H, W, C, k²)
    out = torch.einsum("bhwck,bhwks->bhwcs", patches.float(), kern.float())
    logits = torch.einsum("bhwcs,cn->bhwns", out, w_cls.to(x.dtype).float())
    logits = (logits + bias_comb[:, None]).to(x.dtype)
    return _depth_to_space(logits, up_factor)
