"""Seeded weights, made on the device in a few large calls.

One normal and one uniform draw of the model's whole size from a
``torch.Generator`` on the device; each parameter takes its slice and
scales it by its kind (``reference.param_spec``), the scheme of the
published initialisation: linear weights truncated normal with std 0.02
(cut at two std), linear biases zero, LayerNorm (1, 0), convolution
weights and biases uniform in ±1/√fan_in. The same seed gives the same
tensors on the same device.
"""

from __future__ import annotations

import math

import torch

from . import reference


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 weights by published name, on ``device``."""
    spec = reference.param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "linear":
            t = normal[at:at + n].clamp(-2.0, 2.0).mul(0.02)
        elif kind == "ones":
            t = torch.ones(n, device=device)
        elif kind == "zero":
            t = torch.zeros(n, device=device)
        else:  # conv:<fan_in>
            t = uniform[at:at + n] * (1.0 / math.sqrt(int(kind.split(":")[1])))
        out[name] = t.reshape(shape)
        at += n
    return out
