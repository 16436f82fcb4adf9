"""The native host-ops library (torch counterpart of
``sherf_tpu/native/__init__.py``): ``host_ops.cpp`` (a copy of the JAX
package's, unchanged) built with ``g++ -O3 -march=native -shared -fPIC``
into ``sherf_tpu_torch/_build/libsherf_host-<hash>.so`` at first use and
loaded with ``ctypes``.  The hash keys the source, the flags and the host
CPU (``-march=native`` code does not move between machines).

The contract is the JAX package's: :func:`lib` is None when the library
cannot be built or loaded, and then :func:`prepare_rays_native` returns
None and :func:`fill_convex_poly_native` False, so callers take their numpy
paths.  A failed build prints one warning.  The build writes a temporary
file and renames it into place, so a process never loads a half-written
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> bytes:
    """The model name and ISA flags of this machine's CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_host_cpu())
    return BUILD_DIR / f"libsherf_host-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile ``host_ops.cpp`` (unless built already); the library's path,
    or None when the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        print(f"WARNING: the native host-ops library did not build "
              f"({type(e).__name__}: {e}); the data pipeline takes its numpy "
              f"paths")
        return None
    os.replace(tmp, out)
    return out


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first call), or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            l = ctypes.CDLL(str(path))
        except OSError as e:
            print(f"WARNING: the native host-ops library did not load ({e}); "
                  f"the data pipeline takes its numpy paths")
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        l.generate_rays.argtypes = [ctypes.c_int, ctypes.c_int, f32p, f32p,
                                    f32p, f32p, f32p]
        l.ray_aabb.argtypes = [ctypes.c_int64, f32p, f32p, f32p,
                               ctypes.c_float, f32p, f32p, u8p]
        l.fill_convex_poly.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i32p,
                                       ctypes.c_int]
        l.prepare_rays.argtypes = [ctypes.c_int, ctypes.c_int, f32p, f32p,
                                   f32p, f32p, ctypes.c_float, f32p, f32p,
                                   f32p, f32p, u8p]
        for fn in (l.generate_rays, l.ray_aabb, l.fill_convex_poly,
                   l.prepare_rays):
            fn.restype = None
        _lib = l
        return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def prepare_rays_native(H: int, W: int, K, R, T, bounds, margin: float = 0.01):
    """Rays through every pixel and their AABB entry / exit: (rays_o
    (H*W, 3), rays_d (H*W, 3), near, far, mask_at_box) as float32 / bool
    numpy, or None when the library is unavailable."""
    l = lib()
    if l is None:
        return None
    Kinv = np.ascontiguousarray(np.linalg.inv(K), np.float32)
    R = np.ascontiguousarray(R, np.float32)
    T = np.ascontiguousarray(np.reshape(T, (3,)), np.float32)
    b = np.ascontiguousarray(np.reshape(bounds, (6,)), np.float32)
    n = H * W
    rays_o = np.empty((n, 3), np.float32)
    rays_d = np.empty((n, 3), np.float32)
    near = np.empty((n,), np.float32)
    far = np.empty((n,), np.float32)
    mask = np.empty((n,), np.uint8)
    l.prepare_rays(H, W, _fp(Kinv), _fp(R), _fp(T), _fp(b),
                   ctypes.c_float(margin), _fp(rays_o), _fp(rays_d),
                   _fp(near), _fp(far), _u8(mask))
    return rays_o, rays_d, near, far, mask.astype(bool)


def fill_convex_poly_native(mask: np.ndarray, pts: np.ndarray) -> bool:
    """Fill the convex polygon ``pts`` ((k, 2) int x, y) with 1 in the
    C-contiguous uint8 ``mask``, in place; False when the library is
    unavailable."""
    l = lib()
    if l is None:
        return False
    if (mask.dtype != np.uint8 or mask.ndim != 2
            or not mask.flags["C_CONTIGUOUS"]):
        raise ValueError("mask must be a C-contiguous 2D uint8 array")
    pts = np.ascontiguousarray(pts, np.int32)
    l.fill_convex_poly(_u8(mask), mask.shape[0], mask.shape[1],
                       pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                       pts.shape[0])
    return True
