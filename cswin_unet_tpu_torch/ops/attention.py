"""Cross-shaped-window (CSWin) stripe attention with LePE, plain PyTorch.

Counterpart of ``cswin_unet_tpu.ops.attention``: tokens are split into
``h_sp x w_sp`` stripe windows, each head runs softmax(Q·Kᵀ·scale)·V inside
its window, and LePE — a depthwise 3x3 conv on V *inside each window*, zero
padded at the window's borders, not the image's — is added to the result.

Two roundings of the same function, as in the JAX package:

* ``cswin_attention_xla`` (the JAX composition): Q·scale in the activation
  dtype, scores and softmax in float32, probabilities cast to the
  activation dtype before P·V, which accumulates in float32 and is rounded;
  LePE with taps and bias cast to the activation dtype, rounded after the
  conv and after the bias. The plain version of the fused route's CUDA
  ``stripe_attention`` kernel.
* ``cswin_attention_pallas_plain`` (the JAX Pallas kernel,
  ``cswin_unet_tpu/ops/pallas/cswin_attention.py:82-114``): the same up to
  P·V, then LePE with float32 taps and bias, added to the float32 P·V and
  rounded once. The plain version of the ``pallas`` route's CUDA
  ``cswin_attention`` kernel.

``cswin_attention`` dispatches between the composition and the kernel
route, as ``cswin_unet_tpu.ops.attention.cswin_attention`` does.
"""

from __future__ import annotations

import torch

from .precision import conv2d
from .windows import window_merge, window_partition


def depthwise_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise 3x3 conv, stride 1, zero pad 1, on NHWC ``x``.

    ``weight`` is the torch depthwise layout (C, 1, 3, 3). The sum runs in
    float32 (full float32 for float32 ``x``, forward and backward: cuDNN's
    TF32 off, ``ops.precision.conv2d``) and is rounded once to ``x.dtype``;
    the bias is added in ``x.dtype``, as the JAX composition does.
    """
    C = x.shape[-1]
    y = conv2d(x.float().permute(0, 3, 1, 2), weight.to(x.dtype).float(), padding=1,
               groups=C, dtype=x.dtype)
    y = y.permute(0, 2, 3, 1).to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(N, L, C) -> (N, num_heads, L, C // num_heads)."""
    N, L, C = x.shape
    return x.reshape(N, L, num_heads, C // num_heads).permute(0, 2, 1, 3)


def cswin_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lepe_weight: torch.Tensor,
                        lepe_bias: torch.Tensor | None, *, h_sp: int,
                        w_sp: int, num_heads: int,
                        scale: float) -> torch.Tensor:
    """One stripe branch. q, k, v: (B, H, W, C) -> (B, H, W, C).

    Same function and name as the JAX composition
    ``cswin_unet_tpu.ops.attention.cswin_attention_xla``.
    """
    B, H, W, C = q.shape
    L = h_sp * w_sp

    qw = _heads(window_partition(q, h_sp, w_sp), num_heads)
    kw = _heads(window_partition(k, h_sp, w_sp), num_heads)
    v_img = window_partition(v, h_sp, w_sp).reshape(-1, h_sp, w_sp, C)
    lepe = depthwise_conv3x3(v_img, lepe_weight, lepe_bias)
    vw = _heads(v_img.reshape(-1, L, C), num_heads)
    lepe = _heads(lepe.reshape(-1, L, C), num_heads)

    attn = torch.matmul((qw * scale).float(), kw.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    out = torch.matmul(attn.float(), vw.float())
    out = out.to(q.dtype) + lepe

    out = out.permute(0, 2, 1, 3).reshape(-1, L, C)
    return window_merge(out, h_sp, w_sp, H, W)


def cswin_attention_pallas_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 lepe_weight: torch.Tensor,
                                 lepe_bias: torch.Tensor | None, *, h_sp: int,
                                 w_sp: int, num_heads: int,
                                 scale: float) -> torch.Tensor:
    """One stripe branch with the Pallas kernel's rounding. q, k, v:
    (B, H, W, C) -> (B, H, W, C) in ``q.dtype``.

    LePE runs in float32 on V with the float32 taps (C, 1, 3, 3) and bias,
    and is added to the float32 P·V before the one rounding to ``q.dtype``.
    """
    B, H, W, C = q.shape
    L = h_sp * w_sp

    qw = _heads(window_partition(q, h_sp, w_sp), num_heads)
    kw = _heads(window_partition(k, h_sp, w_sp), num_heads)
    v_img = window_partition(v, h_sp, w_sp).reshape(-1, h_sp, w_sp, C)
    lepe = conv2d(v_img.float().permute(0, 3, 1, 2), lepe_weight.float(),
                  None if lepe_bias is None else lepe_bias.float(), padding=1, groups=C,
                  dtype=q.dtype)
    lepe = _heads(lepe.permute(0, 2, 3, 1).reshape(-1, L, C), num_heads)
    vw = _heads(v_img.reshape(-1, L, C), num_heads)

    attn = torch.matmul((qw * scale).float(), kw.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    out = (torch.matmul(attn.float(), vw.float()) + lepe).to(q.dtype)

    out = out.permute(0, 2, 1, 3).reshape(-1, L, C)
    return window_merge(out, h_sp, w_sp, H, W)


def cswin_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lepe_weight: torch.Tensor, lepe_bias: torch.Tensor | None, *,
                    h_sp: int, w_sp: int, num_heads: int, scale: float,
                    impl: str = "xla") -> torch.Tensor:
    """One stripe branch: ``impl="xla"`` runs the composition;
    ``impl="pallas"`` the CUDA ``cswin_attention`` kernel (its plain version
    on a CPU tensor), whose gradient is autograd of the composition
    (``ops.cuda.cswin_attention.CSWinAttentionFn``)."""
    if impl == "pallas":
        from .cuda.cswin_attention import cswin_attention_kernel_route

        return cswin_attention_kernel_route(q, k, v, lepe_weight, lepe_bias,
                                            h_sp=h_sp, w_sp=w_sp,
                                            num_heads=num_heads, scale=scale)
    if impl != "xla":
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    return cswin_attention_xla(q, k, v, lepe_weight, lepe_bias, h_sp=h_sp,
                               w_sp=w_sp, num_heads=num_heads, scale=scale)
