"""ctypes binding of the native (C++) EDT and HD95 core, compiled on first use.

Counterpart of ``cswin_unet_tpu.utils.native``, on the same source, the
repository's ``native/edt.cpp`` (exact squared EDT and the medpy-convention
HD95, pooled 95th percentile). The port builds its own copy with ``g++``
into ``utils/_native_build/`` (git-ignored), named by the source's digest
and written under a per-process name then renamed, so concurrent first uses
(test workers, ranks) never load a half-written library. The route is the
JAX package's: native when the library builds and loads, scipy otherwise
(``metrics.hd95``); ``available()`` says which route is taken.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "edt.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_native_build"

_lib = None
_tried = False
build_error: str | None = None  # why the native route is off, if it is


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libedt_{digest}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    global _lib, _tried, build_error
    if _tried:
        return _lib
    _tried = True
    try:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        build_error = f"{type(e).__name__}: {e}"
        return None
    lib.hd95.restype = ctypes.c_double
    lib.hd95.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.edt_sq.restype = None
    lib.edt_sq.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
                           ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native route is taken (the library built and loaded)."""
    return _load() is not None


def _as_u8_3d(mask: np.ndarray) -> tuple[np.ndarray, int, int, int, int]:
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if m.ndim == 2:
        return m[None], 1, m.shape[0], m.shape[1], 1
    if m.ndim != 3:
        raise ValueError(f"a 2-D or 3-D mask, got shape {m.shape}")
    return m, m.shape[0], m.shape[1], m.shape[2], 0


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def hd95_native(pred: np.ndarray, gt: np.ndarray) -> float | None:
    """HD95 of two masks of one shape, or None without the library (or when
    the core reports no boundary)."""
    lib = _load()
    if lib is None:
        return None
    a, d, h, w, is2d = _as_u8_3d(pred)
    b, *shape = _as_u8_3d(gt)
    if tuple(shape[:3]) != (d, h, w):
        raise ValueError(f"masks differ in shape: {np.shape(pred)} and {np.shape(gt)}")
    val = lib.hd95(_u8(a), _u8(b), d, h, w, is2d)
    return None if val < 0 else float(val)


def edt_native(mask: np.ndarray) -> np.ndarray | None:
    """Exact euclidean distance of every voxel to the nearest nonzero one, or
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    m, d, h, w, _ = _as_u8_3d(mask)
    out = np.empty((d, h, w), np.float64)
    lib.edt_sq(_u8(m), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), d, h, w)
    out = np.sqrt(out)
    return out[0] if np.ndim(mask) == 2 else out
