"""End-to-end example: solve a 2-D Poisson problem three ways.

Counterpart of the JAX package's ``examples/poisson_solve.py``: construct a
sparse SPD operator, then solve with (1) the dense-path direct solver (the
reference's ``solve``), (2) the fully sparse level-scheduled pipeline, (3)
IC(0)-preconditioned CG, and, with ``--shards`` above 1, (4) distributed CG
over a row-sharded operator (logical ranks on one device, ``LocalComm``).

Run: ``python -m basic_sparse_matrix_tpu_torch.examples.poisson_solve
[--k 32] [--shards 4] [--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .serving import device_scope


def poisson_2d(k: int):
    n = k * k
    idx = np.arange(n)
    i, j = idx // k, idx % k
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0, np.float32)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < k) & (jj >= 0) & (jj < k)
        rows.append(idx[ok])
        cols.append((ii * k + jj)[ok])
        vals.append(np.full(int(ok.sum()), -1.0, np.float32))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--shards", type=int, default=1,
                    help="logical ranks of the distributed CG (1: skip it)")
    ap.add_argument("--device", default=None,
                    help="e.g. cpu; default: the configured device (card)")
    args = ap.parse_args(argv)

    from .. import CSR, solve
    from ..models.pcg import pcg_solve
    from ..models.solve import solve_sparse

    with device_scope(args.device):
        rows, cols, vals, n = poisson_2d(args.k)
        a = CSR.from_coo_arrays((n, n), rows, cols, vals,
                                sum_duplicates=False)
        print(f"operator: {a!r}")
        dense = a.todense().double()

        rng = np.random.default_rng(0)
        b = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                            device=a.device)

        def report(name, x):
            x = x.reshape(-1)[:n].double()
            res = float(torch.linalg.vector_norm(dense @ x - b.double())
                        / torch.linalg.vector_norm(b.double()))
            print(f"{name:>18}: relative residual {res:.2e}")

        report("dense direct", solve(a, b))
        report("sparse direct", solve_sparse(a, b))
        x, iters, _ = pcg_solve(a, b, tol=1e-8, max_iters=1000)
        print(f"{'IC(0)-PCG':>18}: {iters} iterations")
        report("IC(0)-PCG", x)

        if args.shards > 1:
            from ..parallel.cg import cg_solve_sharded
            from ..parallel.mesh import row_mesh
            from ..parallel.sharded import put_sharded, shard_csr

            mesh = row_mesh(args.shards, comm="local", device=a.device)
            sa = put_sharded(shard_csr(a, args.shards), mesh)
            x = cg_solve_sharded(sa, b, mesh, iters=400)
            report(f"distributed CG x{args.shards}", x)


if __name__ == "__main__":
    main()
