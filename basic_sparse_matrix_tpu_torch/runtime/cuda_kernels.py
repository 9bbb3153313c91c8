"""Build and load the port's hand-written CUDA kernels.

The kernels live in ``basic_sparse_matrix_tpu_torch/csrc/*.cu`` behind a
plain C interface. At first use, :func:`load` compiles them with ``nvcc``
for Hopper (``sm_90a``) into one shared library under
``basic_sparse_matrix_tpu_torch/_build/`` (listed in ``.gitignore``) and
loads it with ``ctypes``. The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt and a current build is
reused. Nothing is built when this module is imported, and nothing here
runs on a machine without ``nvcc``: the CPU paths never call :func:`load`.

``nvcc`` is found on ``PATH``, else under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``, the CUDA toolkit's standard location).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("spmm_bsr.cu", "spmm_stream.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# Seconds the last build in this process took (0.0 when an existing build
# was loaded) and what nvcc printed for it (ptxas registers, shared memory,
# spills); both None before the first load().
BUILD_SECONDS: Optional[float] = None
BUILD_LOG: Optional[str] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # blocks, brow_ptr, block_cols, B, C, n_block_rows, rows, K, N, bm, bk,
    # ldb, ldc, stream
    "bsm_spmm_bsr": [_P] * 5 + [_I] * 6 + [_LL, _LL, _P],
    # ii, kk, vv, B, C, n_rt, n_kt, cellmax, tile_m, tile_k, rows, N, ldb,
    # ldc, cw, vec, stream
    "bsm_spmm_stream": [_P] * 5 + [_I] * 7 + [_LL, _LL, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libbsm_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global BUILD_SECONDS, BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    with _lock:
        if _lib is None:
            path = _library_path()
            if path.exists():
                BUILD_SECONDS, BUILD_LOG = 0.0, ""
            else:
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bsm_error_string.argtypes = [ctypes.c_int]
            lib.bsm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_launch(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if status != 0:
        msg = lib.bsm_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
