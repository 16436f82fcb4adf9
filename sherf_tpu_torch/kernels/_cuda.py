"""Build and load the port's hand-written CUDA kernels.

All sources in ``sherf_tpu_torch/csrc/*.cu`` go through ONE ``nvcc``
invocation into a shared library with a plain C interface
(``libsherf_kernels-<hash>.so`` under ``sherf_tpu_torch/_build/``, keyed by
a hash of the sources and flags), loaded with ``ctypes``.  No PyTorch
headers, no ``torch.utils.cpp_extension``, no ``ninja``: a build with
PyTorch's extension builder took minutes where plain ``nvcc`` takes
seconds, and every fresh machine builds anew.

The library is built at first use (never on import).  A failed build or
load raises.  Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises if that is not 0.

``LAUNCHES`` counts, per kernel, the launches: each ``*_cuda`` function adds
one right where it launches its kernel, and nowhere else (a call with
nothing to do, and a CPU call, which takes the plain version, add none).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_ROOT = Path(__file__).resolve().parents[1]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"nn_1": 0, "ray_body_mask": 0, "compact_mask": 0,
            "weighted_accumulate": 0, "nn_1_clustered": 0,
            "nn_1_shortlist": 0, "ray_body_mask_clustered": 0}
# seconds the last nvcc build took in this process (None: loaded from cache
# or not built yet)
BUILD_INFO = {"seconds": None}

_LIB = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sherf_nn1": (_I, [_P, _I, _P, _I, _P, _P, _P]),
    "sherf_ray_body_mask": (_I, [_P, _P, _P, _I, _P, _I, ctypes.c_float, _P, _P]),
    "sherf_compact_mask": (_I, [_P, _I, _I, _P, _P, _P, _P, _P, _P]),
    "sherf_compact_tile": (_I, []),
    "sherf_knn_max_vertices": (_I, []),
    "sherf_nn1_tile": (_I, []),
    "sherf_weighted_accumulate": (_I, [_P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "sherf_wa_max_taps": (_I, []),
    "sherf_wa_tiling": (_I, [_I, _I, _I, _P]),
    "sherf_nn1_clustered": (_I, [_P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P]),
    "sherf_nn1_shortlist": (_I, [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P,
                                 _P]),
    "sherf_ray_body_mask_clustered": (_I, [_P, _P, _I, _P, _I, _P, _P, _I, _I,
                                           ctypes.c_float, _P, _P]),
    "sherf_error_string": (ctypes.c_char_p, [_I]),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, "
                       "PATH): the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libsherf_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the library (if not already built) and
    return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().sherf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` on
    ``device`` whose shape matches ``shape`` (None entries match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and t.shape[i] != s for i, s in enumerate(shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
