"""The distributed pipeline once, end to end, on ``n_devices`` logical
ranks of one device: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.

The same steps in the same order: a 2-D mesh (rows × cols) when
``n_devices`` is even, else a 1-D one; ring SpMM (2-D when the mesh has a
``"cols"`` axis); CG (20 iterations); block-Jacobi PCG (15); the direct
pipeline (``analyze`` → ``factorize_sharded`` → ``csc_to_csr_l`` → forward
and backward ``solve_sparse_distributed``); ``cholesky_supernodal_
distributed``, whose ``L Lᵀ`` must equal A within 1e-3; sharded SpGEMM;
on a 1-D mesh ``bcr_solve_sharded_csr`` (block 8, two right-hand sides),
Lanczos (16) and Chebyshev (80); then the ragged stage: the 13³ Laplacian
under the port's nested-dissection order (``ops/reorder.py``), 2197 rows
on shards that do not divide it, through ring SpMM and PCG (60) to a
relative residual of 1e-4. Each step is held to the JAX dry run's limit.

Every step runs on :class:`~.comm.LocalComm` over ``n_devices`` ranks on
``device`` (default: the configured default device, the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.csr import CSR
from ..utils.config import default_device
from .bcr import bcr_solve_sharded_csr
from .cg import cg_solve_sharded
from .chebyshev import chebyshev_solve_sharded
from .cholesky import factorize_sharded
from .lanczos import eigen_values_lanczos_sharded
from .mesh import make_mesh
from .pcg import build_block_jacobi, pcg_solve_sharded
from .sharded import put_sharded, shard_csr, unshard_rows
from .spgemm_sparse import spgemm_sharded
from .spmm import spmm_ring
from .spmm2d import spmm_ring_2d
from .supernodal import cholesky_supernodal_distributed
from .triangular import solve_sparse_distributed


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _laplacian_13(kk: int = 13):
    """The 7-point stencil on a kk³ grid with diagonal 6.05 (COO)."""
    ns = kk ** 3
    idx = np.arange(ns).reshape(kk, kk, kk)
    rr, cc = [], []
    for ax in range(3):
        lo_s, hi_s = [slice(None)] * 3, [slice(None)] * 3
        lo_s[ax], hi_s[ax] = slice(0, kk - 1), slice(1, kk)
        lo, hi = idx[tuple(lo_s)].ravel(), idx[tuple(hi_s)].ravel()
        rr += [lo, hi]
        cc += [hi, lo]
    rr = np.concatenate(rr + [np.arange(ns)])
    cc = np.concatenate(cc + [np.arange(ns)])
    vv = np.concatenate([-np.ones(rr.shape[0] - ns, dtype=np.float32),
                         6.05 * np.ones(ns, dtype=np.float32)])
    return ns, rr, cc, vv


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the pipeline of the module docstring; raises AssertionError on
    a result outside its limit."""
    from ..models.sparse_cholesky import analyze, csc_to_csr_l
    from ..ops.reorder import nd_permutation, permute_symmetric

    dev = default_device(device)
    if n_devices > 1 and n_devices % 2 == 0:
        mesh = make_mesh((n_devices // 2, 2), ("rows", "cols"),
                         comm="local", device=dev)
    else:
        mesh = make_mesh((n_devices,), ("rows",), comm="local", device=dev)
    num_row_shards = mesh.shape["rows"]

    # Tiny SPD system: tridiagonal 4 / -1.
    n = max(16 * num_row_shards, 64)
    rng = np.random.default_rng(0)
    dense = np.diag(4.0 * np.ones(n, dtype=np.float32))
    off = -np.ones(n - 1, dtype=np.float32)
    dense += np.diag(off, 1) + np.diag(off, -1)
    a = CSR.from_dense(dense, device=dev)
    b = rng.standard_normal((n, 8)).astype(np.float32)
    sa = put_sharded(shard_csr(a, num_row_shards), mesh)

    if "cols" in mesh.axis_names:
        y = spmm_ring_2d(sa, b, mesh)
    else:
        y = spmm_ring(sa, b, mesh)
    got = _host(unshard_rows(y, n))
    _check(np.allclose(got, dense @ b, rtol=1e-4, atol=1e-4),
           "ring SpMM mismatch")

    xr = _host(cg_solve_sharded(sa, b[:, 0], mesh, iters=20))[:n]
    _check(np.allclose(dense @ xr, b[:, 0], rtol=1e-2, atol=1e-2),
           "distributed CG mismatch")

    lfac = build_block_jacobi(sa, mesh)
    xpr = _host(pcg_solve_sharded(sa, b[:, 0], mesh, iters=15,
                                  lfac=lfac))[:n]
    _check(np.allclose(dense @ xpr, b[:, 0], rtol=1e-2, atol=1e-2),
           "distributed PCG mismatch")

    # Direct pipeline: distributed scatter-list Cholesky + distributed
    # triangular solves
    sched = analyze(a)
    lfac_sc = csc_to_csr_l(sched, factorize_sharded(sched, a.values, mesh))
    y1 = solve_sparse_distributed(lfac_sc, b[:, :1], mesh, lower=True)
    xx = solve_sparse_distributed(lfac_sc.transpose(), y1, mesh, lower=False)
    _check(np.allclose(dense @ _host(xx).ravel(), b[:, 0], rtol=1e-2,
                       atol=1e-2), "distributed direct mismatch")

    # Panel-granular: distributed supernodal Cholesky
    l_sn = _host(cholesky_supernodal_distributed(a, mesh).todense())
    _check(np.allclose(l_sn @ l_sn.T, dense, rtol=1e-3, atol=1e-3),
           "distributed supernodal Cholesky mismatch")

    c = spgemm_sharded(a, a, mesh)
    _check(np.allclose(_host(c.todense()), dense @ dense, rtol=1e-4,
                       atol=1e-4), "distributed SpGEMM mismatch")

    # Banded: distributed block cyclic reduction on a 1-D mesh
    mesh1d = make_mesh((n_devices,), ("rows",), comm="local", device=dev)
    xb = _host(bcr_solve_sharded_csr(a, b[:, :2], mesh1d, nb=8))
    _check(np.allclose(dense @ xb, b[:, :2], rtol=1e-2, atol=1e-2),
           "distributed BCR mismatch")

    sa1 = put_sharded(shard_csr(a, n_devices), mesh1d)
    ritz = _host(eigen_values_lanczos_sharded(sa1, mesh1d, k=16, n=n))
    lam = np.linalg.eigvalsh(dense)
    _check(ritz[-1] <= lam[-1] * 1.01 and ritz[0] >= lam[0] * 0.5,
           "distributed Lanczos Ritz values out of spectrum bounds")
    xc, _ = chebyshev_solve_sharded(sa1, b[:, 0], mesh1d, iters=80, n=n)
    xcr = _host(unshard_rows(xc, n))
    _check(np.allclose(dense @ xcr, b[:, 0], rtol=1e-2, atol=1e-2),
           "distributed Chebyshev mismatch")

    # Ragged stage: 2197 rows do not divide into n_devices shards.
    ns, rr, cc, vv = _laplacian_13()
    a3 = CSR.from_coo_arrays((ns, ns), rr, cc, vv, device=dev)
    a3 = permute_symmetric(a3, nd_permutation(a3))
    _check(ns % n_devices != 0, "the ragged stage needs ragged shards")
    sa3 = put_sharded(shard_csr(a3, n_devices), mesh1d)
    b3 = rng.standard_normal(ns).astype(np.float32)
    ip, ix, va = a3.numpy()
    a3_dense = np.zeros((ns, ns))
    np.add.at(a3_dense, (np.repeat(np.arange(ns), np.diff(ip)), ix), va)
    y3 = _host(unshard_rows(spmm_ring(sa3, b3[:, None], mesh1d), ns))
    _check(np.abs(y3.ravel() - a3_dense @ b3).max() < 1e-3,
           "ragged-scale ring SpMM mismatch")
    lfac3 = build_block_jacobi(sa3, mesh1d)
    x3 = _host(unshard_rows(pcg_solve_sharded(sa3, b3, mesh1d, iters=60,
                                              lfac=lfac3), ns))
    rel3 = np.linalg.norm(a3_dense @ x3 - b3) / np.linalg.norm(b3)
    _check(rel3 < 1e-4, f"ragged-scale PCG residual {rel3}")
