"""Build the hand-written CUDA kernels on first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface. The library's name carries
a hash of the sources and flags, and it lives in ``_build/`` beside this
file (ignored by git), so a changed source rebuilds and an unchanged one
loads at once. Nothing here runs at import time: the CPU tests import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
# C signatures of csrc/*.cu; a function returns a cudaError_t as int unless
# _RESTYPES says otherwise.
_SIGNATURES = {
    "cswin_layernorm": (_P, _P, _P, _P, _I, _I, _F, _P),
    "cswin_layernorm_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "cswin_layernorm_bwd_ctas_per_sm": (_I,),
    "cswin_gemm": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _LL, _F,
                   _U, _P),
    "cswin_gemm_wgrad": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P, _LL, _F, _U, _P),
    "cswin_gemm_wgrad_max_clusters": (_I, _I, _I),
    "cswin_stripe_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _P),
    "cswin_cswin_attention": (_P, _P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _F, _P),
    "cswin_stripe_attention_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _P),
    "cswin_stripe_attention_bwd_smem": (_I, _I),
    "cswin_stripe_attention_bwd_split": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _I, _F, _P),
    "cswin_stripe_attention_bwd_plan": (_I, _I, _I),
    "cswin_carafe": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "cswin_edt_pass": (_P, _P, _LL, _I, _LL, _P),
    "cswin_edt_pass_lines": (_I, _I),
    "cswin_block_pair": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P),
    "cswin_block_one": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P,
                        _P),
    "cswin_lepe_windows": (_P, _LL, _P, _LL, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P),
    "cswin_window_attention": (_P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                               _I, _P),
    "cswin_lepe_windows_plan": (_I, _I, _I, _I, _I, _I, _I, _I, _P),
    "cswin_ln_mlp": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P),
    "cswin_ln_mlp_plan": (_I, _I, _I, _I, _P),
    # the float32 instances of the serving path (TPU.COMPUTE_DTYPE float32)
    "cswin_layernorm_f32": (_P, _P, _P, _P, _I, _I, _F, _P),
    "cswin_gemm_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _LL,
                       _F, _U, _I, _I, _I, _P),
    "cswin_gemm_f32_smem": (_I, _I, _I),
    "cswin_stripe_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _P),
    "cswin_cswin_attention_f32": (_P, _P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _P),
    "cswin_stripe_attention_f32_smem": (_I, _I),
    "cswin_carafe_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "cswin_carafe_f32_smem": (_I, _I, _I, _I),
    "cswin_block_pair_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P),
    # and of the training path's backward (training at float32)
    "cswin_layernorm_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "cswin_layernorm_bwd_f32_ctas_per_sm": (_I,),
    "cswin_gemm_wgrad_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P, _LL, _F, _U, _P),
    "cswin_gemm_wgrad_f32_max_clusters": (_I, _I, _I),
    "cswin_stripe_attention_bwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _F, _P),
    "cswin_stripe_attention_bwd_f32_smem": (_I, _I, _I),
}

# Entry points that return something other than a cudaError_t (a count).
_RESTYPES = {"cswin_stripe_attention_bwd_smem": ctypes.c_longlong,
             "cswin_stripe_attention_bwd_plan": ctypes.c_longlong,
             "cswin_stripe_attention_f32_smem": ctypes.c_longlong,
             "cswin_stripe_attention_bwd_f32_smem": ctypes.c_longlong}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the last build, if any
build_log: str = ""                  # nvcc's output (-Xptxas -v resource use)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the kernel library of the current sources lives (built or not)."""
    return BUILD_DIR / f"libcswin_kernels_{_digest()}.so"


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump``, beside ``nvcc``."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    return tool


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiling it first if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
        tmp = so.with_name(f"{tag}.so.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [src.name for src, p in zip(_sources(), procs) if p.returncode]
        if not failed:
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True, check=False)
            build_log += link.stdout + link.stderr
            failed = ["link"] if link.returncode else []
        build_seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
