"""Minimal NIfTI-1 (.nii.gz) volume writer.

Replaces the reference's SimpleITK export (``utils.py:92-101``) without the
dependency: writes a single-file NIfTI-1 (348-byte header + float32 data,
gzip-compressed) with the given (x, y, z) spacing. Arrays are (D, H, W)
z-major like the reference's numpy volumes; NIfTI dims are stored
fastest-first (W, H, D), matching sitk.GetImageFromArray conventions.

The port's own copy of ``cswin_unet_tpu.utils.nifti``: the same bytes for
the same volume and spacing.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np


def write_nifti(path: str, volume: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> None:
    vol = np.asarray(volume, dtype=np.float32)
    assert vol.ndim == 3, vol.shape
    d, h, w = vol.shape

    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)                     # sizeof_hdr
    struct.pack_into("<8h", header, 40, 3, w, h, d, 1, 1, 1, 1)  # dim
    struct.pack_into("<h", header, 70, 16)                     # datatype float32
    struct.pack_into("<h", header, 72, 32)                     # bitpix
    struct.pack_into(
        "<8f", header, 76, 1.0, spacing[0], spacing[1], spacing[2], 0, 0, 0, 0
    )                                                           # pixdim
    struct.pack_into("<f", header, 108, 352.0)                 # vox_offset
    struct.pack_into("<f", header, 112, 1.0)                   # scl_slope
    struct.pack_into("<b", header, 123, 10)                    # xyzt_units mm|s
    struct.pack_into("<h", header, 252, 1)                     # qform_code
    struct.pack_into("<f", header, 264, 1.0)                   # quatern b..d = 0 -> identity
    struct.pack_into("<3f", header, 268, 0.0, 0.0, 0.0)        # qoffset
    struct.pack_into("<4s", header, 344, b"n+1\x00")           # magic

    with gzip.open(path, "wb") as f:
        f.write(bytes(header))
        f.write(b"\x00" * 4)  # extension flag
        f.write(vol.tobytes())
