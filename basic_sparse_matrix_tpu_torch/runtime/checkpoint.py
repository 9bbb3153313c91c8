"""Checkpoint / resume for sparse matrices and factorizations.

Counterpart of ``basic_sparse_matrix_tpu/runtime/checkpoint.py``: ``.npz``
save/load of CSR triples and banded factors, prepared direct solvers, and
mid-factorization checkpointing, so that a long level-scheduled
factorization resumes from the last completed level.

The ``.npz`` key names and ``kind`` tags are the JAX package's, so a
checkpoint written by either package loads in the other. Loaders take the
``device`` the state should live on (default: the CPU, as the port's
constructors do).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_csr(path: str, a: CSR) -> None:
    indptr, indices, values = a.numpy()
    np.savez_compressed(
        path, indptr=indptr, indices=indices, values=values,
        rows=a.rows, cols=a.cols, kind="csr",
    )


def load_csr(path: str, device=None) -> CSR:
    with np.load(path) as z:
        return CSR.from_coo_arrays(
            (int(z["rows"]), int(z["cols"])),
            np.repeat(np.arange(int(z["rows"])), np.diff(z["indptr"])),
            z["indices"],
            z["values"],
            sum_duplicates=False,
            drop_zeros=False,
            device=device,
        )


def _bcr_arrays(fac) -> dict:
    return dict(D=_np(fac.D), E=_np(fac.E), nb=fac.nb)


def _banded_arrays(fac) -> dict:
    return dict(L=_np(fac.L), F=_np(fac.F))


def _load_bcr(z, n: int, device):
    """A ``BCRSolver`` from saved D/E blocks. The elimination state is a
    tuple of per-level stacks, so a checkpoint holds the blocks and the
    factorization is run again here. Blocks saved unpadded (the JAX
    package's) or already padded to a power of two of block rows (the
    port's) both load: padding a padded operand changes nothing."""
    from ..models.bcr import bcr_from_blocks

    return bcr_from_blocks(to_tensor(z["D"], device),
                           to_tensor(z["E"], device), n)


def _load_banded(z, n: int, device):
    from ..models.banded import BandedFactor

    return BandedFactor(L=to_tensor(z["L"], device),
                        F=to_tensor(z["F"], device), n=n)


def save_banded(path: str, fac) -> None:
    """Persist a banded direct-solve factor: a ``BandedFactor`` (scan
    backend) as its L/F blocks; a ``BCRSolver`` as its D/E operand
    blocks."""
    from ..models.bcr import BCRSolver

    if isinstance(fac, BCRSolver):
        np.savez_compressed(path, n=fac.n, kind="bcr-blocks",
                            **_bcr_arrays(fac))
        return
    np.savez_compressed(path, n=fac.n, kind="banded", **_banded_arrays(fac))


def load_banded(path: str, device=None):
    with np.load(path) as z:
        if "kind" in z and str(z["kind"]) == "bcr-blocks":
            return _load_bcr(z, int(z["n"]), device)
        return _load_banded(z, int(z["n"]), device)


def save_direct(path: str, solver) -> None:
    """Persist a prepared ``DirectSolver`` with its fill-reducing
    permutation (the banded factor alone lives in permuted space). Banded
    backends only, as in the JAX package; the supernodal and scatter-list
    tiers are rebuilt with ``prepare_direct``."""
    perm = (np.asarray(solver.perm) if solver.perm is not None
            else np.empty(0, dtype=np.int64))
    if solver.kind == "banded-bcr":
        np.savez_compressed(path, perm=perm, n=solver.n, kind="direct-bcr",
                            **_bcr_arrays(solver._banded))
    elif solver.kind == "banded":
        np.savez_compressed(path, perm=perm, n=solver.n,
                            kind="direct-banded",
                            **_banded_arrays(solver._banded))
    else:
        raise ValueError(
            f"save_direct supports the banded backends, not {solver.kind!r};"
            " rebuild via prepare_direct instead")


def load_direct(path: str, device=None):
    """Reload a :func:`save_direct` checkpoint (this package's or the JAX
    package's) as a ready ``DirectSolver`` on ``device``.

    Only what a checkpoint holds is read: the permutation and the banded
    blocks. The tiers whose state differs in layout between the packages by
    design (the ragged triangular-solve schedules of the supernodal and
    scatter-list tiers, where the JAX package pads) are never serialised by
    either package; there, and for the BCR elimination state here, the
    state is rebuilt from the operands rather than read in a padded
    form."""
    from ..models.solve import DirectSolver

    with np.load(path) as z:
        s = DirectSolver.__new__(DirectSolver)
        s.n = int(z["n"])
        s.device = torch.device("cpu" if device is None else device)
        perm = z["perm"]
        s.perm = perm if perm.size else None
        s.timings = {}
        s._l = s._fwd = s._bwd = None
        if str(z["kind"]) == "direct-bcr":
            s.kind = "banded-bcr"
            s._banded = _load_bcr(z, s.n, device)
        else:
            s.kind = "banded"
            s._banded = _load_banded(z, s.n, device)
        return s


def save_factor_state(path: str, lvals, level_done: int,
                      meta: Optional[dict] = None) -> None:
    """Persist a partially completed numeric factorization: the factor
    value array plus the index of the last fully applied level."""
    np.savez_compressed(
        path, lvals=_np(lvals), level_done=level_done, **(meta or {}),
    )


def load_factor_state(path: str) -> Tuple[np.ndarray, int]:
    with np.load(path) as z:
        return z["lvals"], int(z["level_done"])


def checkpointed_factorize(sched, a_values, path: str,
                           every: int = 64) -> np.ndarray:
    """Run the level-scheduled Cholesky numeric phase
    (``models.sparse_cholesky``) with periodic host-side checkpoints;
    resumes from ``path`` if present.

    Drives the same per-level step as ``sparse_cholesky.factorize`` in
    ``every``-level chunks on ``a_values``' device and snapshots the factor
    values (scratch slot included) between chunks. Levels are those of the
    schedule handed in, so a state file belongs to the package whose
    schedule wrote it. Returns the factor's CSC values on the host."""
    from ..models.sparse_cholesky import factor_levels, initial_lvals

    a_values = torch.as_tensor(a_values)
    nlev = sched.n_levels
    start = 0
    if os.path.exists(path):
        lvals_np, start = load_factor_state(path)
        lvals = to_tensor(lvals_np, a_values.device)
    else:
        lvals = initial_lvals(sched, a_values)
    lv = start
    while lv < nlev:
        hi = min(lv + every, nlev)
        factor_levels(sched, lvals, lv, hi)
        lv = hi
        if lv < nlev:
            save_factor_state(path, lvals, lv)
    return _np(lvals)[:-1]
