"""Full float32 convolutions where the activations are float32.

On the card a float32 convolution goes through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits of each operand; the JAX package's float32 convolutions are
full float32. ``conv_precision(dtype)`` switches TF32 off for the calls made
inside it when ``dtype`` is float32, and leaves the flags alone otherwise, so
the bf16 route does not change. The flag is scoped to the call: no entry
point sets it for the process.
"""

from __future__ import annotations

import contextlib

import torch


def conv_precision(dtype: torch.dtype):
    """A context for convolutions on activations of ``dtype``: cuDNN's
    TF32 off at float32 (the other cuDNN flags as they are), nothing
    otherwise."""
    if dtype != torch.float32:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)
