"""Build and bind the Hopper kernels of `csrc/`.

All CUDA sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes.  The build runs at the first kernel launch,
never at import, into `csrc/_build/` (listed in .gitignore); the library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.

Flags: sm_90a, -O3, and --fmad=false, which keeps the compiler from
fusing a multiply and an add into one rounding where the plain PyTorch
versions round twice (see csrc/orb.cu).  No --use_fast_math: it would
swap atan2f, sinf and cosf for approximations.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("fast.cu", "orb.cu", "stereo.cu", "stamp.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # n_levels, ptrs (host void*[2n]), ints (host int[4n]), n_cells,
    # ini_th, min_th, border, cell, stream
    "orb_fast_levels": (_I, _P, _P, _I, _F, _F, _I, _I, _P),
    # pattern, umax, stream
    "orb_set_tables": (_P, _P, _P),
    # n_levels, ptrs (host void*[4n]), ints (host int[4n]), n_rows, angle,
    # desc, stream
    "orb_describe_levels": (_I, _P, _P, _I, _P, _P, _P),
    # left, right, h, w, yc, xl, xr, n, scores, stream
    "orb_sad_strips": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P),
    # left, right, h, w, xy_l, xy_r, best_idx, best_dist, th_orb, bf,
    # min_disp, max_disp, n, u_right, depth, sad, scores (or null), stream
    "orb_stereo_refine": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                          _I, _P, _P, _P, _P, _P),
    # buf (int64), slot, stream
    "orb_stamp": (_P, _I, _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"liborb_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the library unless it is already built; return its path.
    The compiler's report (-Xptxas -v: registers, shared memory, spills)
    goes to a .log beside it."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"[{time.perf_counter() - t0:.1f} s, rc {proc.returncode}]\n")
    path.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` (None
    matches any size) on `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def host_array(ctype, values) -> ctypes.Array:
    """`values` as a ctypes array in host memory, for a C entry that copies
    a level table into a kernel's by-value parameter; pass it as
    `ctypes.addressof(array)` and keep the array alive for the call."""
    return (ctype * len(values))(*values)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, name: str) -> torch.device:
    """The CUDA device of `t`, or raise: a kernel wrapper never moves data."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got "
                         f"{t.device}")
    return t.device
