"""FLOPs and parameter counts (the reference's thop.profile, test.py:244-251).

Counterpart of ``cswin_unet_tpu.utils.flops``, which reads XLA's cost
analysis; here the FLOPs are torch's own count,
``torch.utils.flop_counter.FlopCounterMode`` over one forward (products and
convolutions, 2 per multiply-add), so the two packages' FLOPs figures are
not the same measure. The parameter count is the same: every parameter
tensor's size.
"""

from __future__ import annotations

import torch


def clever_format(value: float) -> str:
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if value >= div:
            return f"{value / div:.3f}{unit}"
    return f"{value:.3f}"


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_flops(model: torch.nn.Module, img_size: int, channels: int = 3) -> int:
    """torch's FLOP count of one forward at batch 1 on the model's device."""
    from torch.utils.flop_counter import FlopCounterMode

    device = next(model.parameters()).device
    x = torch.zeros((1, img_size, img_size, channels), device=device)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()
