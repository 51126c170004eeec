"""Native (C++) runtime components, bound via ctypes.

Copied from orb_slam2_tpu/native: host code, no device kernel.  `mapcore`
is the observation/covisibility engine (see mapcore.cpp).  It is built
with g++ on first use (not at import); when the toolchain is unavailable
the package falls back to the pure-Python structures transparently.  The
library goes to `_build/` (not a package, so module walkers never take
it for a Python extension); the build writes a temporary file there and
renames it into place, so processes that build at once never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mapcore.cpp")
_BUILD = os.path.join(_DIR, "_build")
_LIB = os.path.join(_BUILD, "libmapcore.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
             "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the mapcore shared library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or (
            os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None

    c = ctypes
    lib.mapcore_create.restype = c.c_void_p
    lib.mapcore_destroy.argtypes = [c.c_void_p]
    lib.mapcore_clear.argtypes = [c.c_void_p]
    lib.mapcore_add_obs.argtypes = [
        c.c_void_p, c.c_int64, c.c_int32, c.c_int32, c.c_int32]
    lib.mapcore_add_obs.restype = c.c_int
    lib.mapcore_add_obs_batch.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int32,
        c.POINTER(c.c_uint8)]
    lib.mapcore_add_obs_batch.restype = c.c_int
    lib.mapcore_erase_obs.argtypes = [c.c_void_p, c.c_int64, c.c_int32]
    lib.mapcore_erase_obs.restype = c.c_int
    lib.mapcore_clear_point.argtypes = [c.c_void_p, c.c_int64]
    lib.mapcore_n_obs.argtypes = [c.c_void_p, c.c_int64]
    lib.mapcore_n_obs.restype = c.c_int
    lib.mapcore_count.argtypes = [c.c_void_p, c.c_int64]
    lib.mapcore_count.restype = c.c_int
    lib.mapcore_get_obs.argtypes = [
        c.c_void_p, c.c_int64, c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.c_int32]
    lib.mapcore_get_obs.restype = c.c_int
    lib.mapcore_find.argtypes = [c.c_void_p, c.c_int64, c.c_int32]
    lib.mapcore_find.restype = c.c_int
    lib.mapcore_dump_obs.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int32]
    lib.mapcore_dump_obs.restype = c.c_int
    lib.mapcore_count_observers.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int32]
    lib.mapcore_count_observers.restype = c.c_int
    lib.mapcore_distinctive.argtypes = [c.POINTER(c.c_uint32), c.c_int32]
    lib.mapcore_distinctive.restype = c.c_int
    lib.mapcore_distinctive_batch.argtypes = [
        c.POINTER(c.c_uint32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int32, c.POINTER(c.c_int32)]
    lib.mapcore_raycast.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.POINTER(c.c_int64), c.c_int32]
    _lib = lib
    return _lib
