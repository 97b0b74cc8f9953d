"""The ``pallas`` route's stripe attention: one branch through the CUDA
``cswin_attention`` kernel, with a gradient.

Counterpart of ``cswin_unet_tpu/ops/pallas/cswin_attention.py``
(``cswin_attention_pallas``, a ``jax.custom_vjp``): the forward is the
kernel (the Pallas kernel's rounding: float32 LePE, one rounding), and the
backward is autograd of the composition ``cswin_attention_xla`` recomputed
from the saved q, k, v and LePE parameters (``_bwd``, :195-205). The JAX
package has no backward kernel for this route, and neither has the port.
"""

from __future__ import annotations

import torch

from ..attention import cswin_attention_xla
from .kernels import cswin_attention, needs_grad


class CSWinAttentionFn(torch.autograd.Function):
    """Kernel forward, composition-vjp backward, for one stripe branch."""

    @staticmethod
    def forward(ctx, q, k, v, lepe_weight, lepe_bias, h_sp, w_sp, num_heads, scale):
        ctx.kw = dict(h_sp=h_sp, w_sp=w_sp, num_heads=num_heads, scale=scale)
        ctx.has_bias = lepe_bias is not None
        ctx.save_for_backward(q, k, v, lepe_weight, lepe_bias)
        return cswin_attention(q, k, v, lepe_weight, lepe_bias, **ctx.kw)

    @staticmethod
    def backward(ctx, gout):
        q, k, v, lw, lb = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (q, k, v, lw)]
        if ctx.has_bias:
            leaves.append(lb.detach().requires_grad_())
        with torch.enable_grad():
            out = cswin_attention_xla(*leaves[:4], leaves[4] if ctx.has_bias else None,
                                      **ctx.kw)
            grads = torch.autograd.grad(out, leaves, gout)
        db = grads[4] if ctx.has_bias else None
        return (*grads[:4], db, None, None, None, None)


def cswin_attention_kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 lepe_weight: torch.Tensor,
                                 lepe_bias: torch.Tensor | None, *, h_sp: int,
                                 w_sp: int, num_heads: int,
                                 scale: float) -> torch.Tensor:
    """One stripe branch (B, H, W, C) -> (B, H, W, C) through the kernel;
    through ``CSWinAttentionFn`` where autograd needs gradients."""
    if needs_grad(q, k, v, lepe_weight, lepe_bias):
        return CSWinAttentionFn.apply(q, k, v, lepe_weight, lepe_bias, h_sp, w_sp,
                                      num_heads, scale)
    return cswin_attention(q, k, v, lepe_weight, lepe_bias, h_sp=h_sp, w_sp=w_sp,
                           num_heads=num_heads, scale=scale)
