"""Build and load the port's hand-written CUDA kernels.

The kernels live in ``basic_sparse_matrix_tpu_torch/csrc/*.cu`` behind a
plain C interface. At first use, :func:`load` compiles them with ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, links the objects into one shared library under
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
SOURCES = ("spmm_bsr.cu", "spmm_stream.cu", "runs_read.cu", "addback.cu",
           "entry_fma.cu", "trsv_level.cu", "ell_spmm.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
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
    # blocks, live_ptr, live_idx, block_cols, B, C, n_block_rows, rows, K,
    # N, bm, bk, ldb, ldc, passes, stream
    "bsm_spmm_bsr": [_P] * 6 + [_I] * 6 + [_LL, _LL, _I, _P],
    # bm, passes, out[7]
    "bsm_spmm_bsr_info": [_I, _I, _P],
    # ii, kk, vv, B, C, n_rt, n_kt, cellmax, tile_m, tile_k, rows, N, ldb,
    # ldc, cw, vec, stream
    "bsm_spmm_stream": [_P] * 5 + [_I] * 7 + [_LL, _LL, _I, _I, _P],
    # rp, kk, vv, B, C, rows, N, tile_m, cellmax, ldb, ldc, stream
    "bsm_spmm_stream_sliced": [_P] * 5 + [_I] * 4 + [_LL] * 2 + [_P],
    # A, out, pieces, iters, blocks, stream
    "bsm_l2_gather_probe": [_P, _P, _LL, _I, _I, _P],
    # lvals, n, stf, crq, l_pad, bt, out, stream
    "bsm_runs_read": [_P, _LL, _P, _I, _I, _I, _P, _P],
    # lvals, n, rows, starts, twd (or null), wt, nslots, len, stream
    "bsm_addback": [_P, _LL, _P, _P, _P, _I, _I, _I, _P],
    # lvals, n, p, tcp, tnr, twd, Bt, St, Rd, Wt, idx64, stream
    "bsm_addback_rects": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # ii, kk, vv, B, C, entries, rows, lanes, vec, stream
    "bsm_entry_fma": [_P] * 5 + [_LL, _I, _I, _I, _P],
    # y, vals, inv_diag, cols, eptr, levels, units, ready, plan (host),
    # launches, n, k, bt, nnz, vstride, dstride, stream
    "bsm_trsv": [_P] * 9 + [_I] * 4 + [_LL, _LL, _LL, _P],
    # out[8]
    "bsm_trsv_info": [_P],
    # cols, vals, B, C, rows, width, n, sb0, sb1, ldc, threads, stream
    "bsm_ell_spmm": [_P] * 4 + [_LL, _I, _I, _LL, _LL, _LL, _I, _P],
    # B, C, width, n, sb0, sb1, ldc, out[2]
    "bsm_ell_spmm_shape": [_P, _P, _I, _I, _LL, _LL, _LL, _P],
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


def _run_all(cmds) -> str:
    """Run the commands at once; raise on the first that fails, else
    return their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(out: Path) -> None:
    global BUILD_SECONDS, BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                         str(CSRC / name)]
                        for name, obj in zip(SOURCES, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log


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
