"""Dropout (``MODEL.DROP_RATE``) with counter-based masks.

Counterpart of flax ``nn.Dropout(rate)`` in training, as the JAX model
applies it after the stem's LayerNorm and after each MLP's GELU and fc2
(``cswin_unet_tpu/models/cswin_unet.py:60,67,490``): ``select(mask,
x / keep, 0)`` in ``x``'s dtype, ``keep = 1 − rate`` rounded to that dtype
first (a Python float divides a bf16 array as a bf16 scalar there), an
independent draw for each element; rate 1 gives zeros.

A site's mask is a function of one 64-bit key and the element's global index
``(row0 + row)·cols + col``: bit ``i`` is kept when word ``i % 4`` of
Philox-4x32-10 (Salmon et al., SC'11) at counter ``(i // 4, 0)`` and that
key is below ``keep_threshold(rate)``. The keys come from the caller's
generator (``draw_keys``), one per site and step, so

  * the backward regenerates a mask instead of keeping it;
  * a rank that computes rows ``[row0, row0 + rows)`` of the global batch
    draws the bits one process would draw for those rows;
  * the CUDA GEMM epilogues (``ops/cuda/csrc/philox.cuh``) compute the same
    bits from (key, row, column) as ``keep_mask`` does here, with exact
    integer arithmetic: each 32 x 32-bit product is split into two of
    16 x 32 bits, so no int64 product overflows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # and key increments
_LO32 = 0xFFFFFFFF
_CHUNK = 1 << 22  # counters a pass of keep_mask (bounds its int64 temporaries)


class Drop(NamedTuple):
    """One dropout site of one step: ``key`` a (1,) int64 tensor on the
    device of the activations, ``rate`` in (0, 1], ``row0`` the global index
    of the first row this process computes (its rank's offset in the global
    batch)."""

    key: torch.Tensor
    rate: float
    row0: int = 0


def keep_threshold(rate: float) -> int:
    """An element is kept when its 32-bit Philox word is below this."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate {rate} is outside [0, 1]")
    return min(int((1.0 - rate) * 2**32), 2**32 - 1)


def keep_divisor(rate: float, dtype: torch.dtype) -> float:
    """``1 − rate`` rounded to ``dtype``: what flax divides a kept element
    by (0 at rate 1)."""
    return float(torch.tensor(1.0 - rate, dtype=torch.float64).to(dtype))


def draw_keys(generator: torch.Generator, n: int) -> torch.Tensor:
    """``n`` 64-bit keys (int64, on the generator's device) from
    ``generator``: two 32-bit draws each."""
    w = torch.randint(0, 2**32, (n, 2), generator=generator, device=generator.device,
                      dtype=torch.int64)
    return w[:, 0] | (w[:, 1] << 32)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a·b`` for a constant ``a`` < 2^32 and
    ``b`` int64 holding 32-bit values: two products of < 2^48."""
    p1 = (b >> 16) * a
    p0 = (b & 0xFFFF) * a
    t = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (t >> 32), t & _LO32


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor,
                  high: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Philox-4x32-10 of the 64-bit ``counter`` values (int64; counter words
    2 and 3 are ``high``, zero for the masks) under the 64-bit ``key``
    (int64 scalar tensor): (n, 4) int64 holding the four 32-bit output
    words."""
    c0, c1 = counter & _LO32, (counter >> 32) & _LO32
    c2, c3 = (torch.full_like(c0, w) for w in high)
    k0, k1 = key & _LO32, (key >> 32) & _LO32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _LO32, (k1 + _W1) & _LO32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), -1)


def keep_mask(key: torch.Tensor, row0: int, rows: int, cols: int,
              rate: float) -> torch.Tensor:
    """The keep mask (rows, cols) bool of a site, on ``key``'s device: the
    bits of global elements ``[row0·cols, (row0 + rows)·cols)``."""
    start, n = row0 * cols, rows * cols
    thr = keep_threshold(rate)
    key = key.reshape(()).to(torch.int64)
    out = torch.empty(n, dtype=torch.bool, device=key.device)
    for lo in range(start - start % 4, start + n, 4 * _CHUNK):
        hi = min(lo + 4 * _CHUNK, start + n)
        q = torch.arange(lo // 4, -(-hi // 4), device=key.device, dtype=torch.int64)
        words = philox4x32_10(q, key).reshape(-1)
        a = max(lo, start)
        out[a - start:hi - start] = words[a - lo:hi - lo] < thr
    return out.view(rows, cols)


def dropout(x: torch.Tensor, drop: Drop | None) -> torch.Tensor:
    """flax's ``Dropout`` in training on ``x`` (..., cols): kept elements
    ``round(x / keep)`` in ``x.dtype``, the others 0. Differentiable."""
    if drop is None:
        return x
    cols = x.shape[-1]
    m = keep_mask(drop.key, drop.row0, x.numel() // cols, cols, drop.rate).view(x.shape)
    kd = keep_divisor(drop.rate, x.dtype)
    return torch.where(m, x / kd if kd else x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
