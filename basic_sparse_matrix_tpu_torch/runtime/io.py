"""Matrix Market I/O (SuiteSparse interchange format).

Counterpart of ``basic_sparse_matrix_tpu/runtime/io.py``: the coordinate
format (general and symmetric; real, integer and pattern), plain or ``.gz``,
without external dependencies. The writer's text is the JAX package's byte
for byte, so either package reads what the other wrote.
"""

from __future__ import annotations

import gzip

import numpy as np

from ..ops.csr import CSR


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def read_matrix_market(path: str, device=None) -> CSR:
    """Load a Matrix Market coordinate file as a float32 CSR on ``device``.
    Symmetric/skew files are expanded to full storage (both triangles)."""
    with _open(path, "r") as f:
        header = f.readline().strip().split()
        if (len(header) < 5 or header[0] != "%%MatrixMarket"
                or header[1] != "matrix" or header[2] != "coordinate"):
            raise ValueError(f"unsupported MatrixMarket header: {header}")
        field, symmetry = header[3], header[4]
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, nnz = (int(t) for t in line.split())
        r = np.empty(nnz, dtype=np.int64)
        c = np.empty(nnz, dtype=np.int64)
        v = np.empty(nnz, dtype=np.float64)
        for k in range(nnz):
            parts = f.readline().split()
            r[k] = int(parts[0]) - 1
            c[k] = int(parts[1]) - 1
            v[k] = 1.0 if field == "pattern" else float(parts[2])
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = r != c
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        r, c, v = (
            np.concatenate([r, c[off]]),
            np.concatenate([c, r[off]]),
            np.concatenate([v, sign * v[off]]),
        )
    return CSR.from_coo_arrays(
        (rows, cols), r, c, v.astype(np.float32),
        sum_duplicates=True, drop_zeros=False, device=device,
    )


def write_matrix_market(path: str, a: CSR, comment: str = "") -> None:
    """Write CSR as a general real coordinate Matrix Market file."""
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(a.rows), np.diff(indptr))
    with _open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{a.rows} {a.cols} {a.stored}\n")
        for r, c, v in zip(rows, indices, values):
            f.write(f"{int(r) + 1} {int(c) + 1} {float(v):.17g}\n")


def bcsstk_like(n: int = 100, bandwidth: int = 8, seed: int = 0,
                device=None) -> CSR:
    """Synthetic SPD matrix with a bcsstk-style banded structure: symmetric
    banded pattern with random fill, made SPD by diagonal dominance. The
    same numpy draws as the JAX package, so the same matrix for a seed."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l, vals_l = [], [], []
    for off in range(1, bandwidth + 1):
        m = n - off
        mask = rng.random(m) < 0.6
        idx = np.nonzero(mask)[0]
        val = rng.standard_normal(idx.shape[0])
        rows_l.append(idx + off)
        cols_l.append(idx)
        vals_l.append(val)
        rows_l.append(idx)
        cols_l.append(idx + off)
        vals_l.append(val)
    rows = np.concatenate(rows_l) if rows_l else np.empty(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.empty(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.empty(0, np.float64)
    diag = np.zeros(n)
    np.add.at(diag, rows, np.abs(vals))
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, diag + 1.0])
    return CSR.from_coo_arrays((n, n), rows, cols,
                               vals.astype(np.float32), device=device)
