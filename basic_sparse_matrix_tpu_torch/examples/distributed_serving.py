"""Distributed serving: shard an SPD operator over a row mesh once, then
serve repeated solves and spectral queries from the resident shards.

Counterpart of the JAX package's ``examples/distributed_serving.py``. The
mesh is ``row_mesh(--shards)``: logical ranks in one process
(``LocalComm``) on one device, or, inside an initialised
``torch.distributed`` process group, one rank per process.

Run: ``python -m basic_sparse_matrix_tpu_torch.examples.distributed_serving
[--shards 8] [--k 24] [--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .serving import device_scope


def lap2d(k: int) -> np.ndarray:
    """The dense 5-point Laplacian on a k×k grid."""
    n = k * k
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(k):
        for j in range(k):
            r = i * k + j
            a[r, r] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < k and 0 <= jj < k:
                    a[r, ii * k + jj] = -1.0
    return a


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh ranks (default: row_mesh()'s)")
    ap.add_argument("--k", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="e.g. cpu; default: the configured device (card)")
    args = ap.parse_args(argv)

    from .. import CSR
    from ..parallel.mesh import row_mesh
    from ..parallel.operator import DistributedOperator

    with device_scope(args.device):
        a = lap2d(args.k)
        n = a.shape[0]
        csr = CSR.from_dense(a)
        mesh = row_mesh(args.shards, device=csr.device)
        op = DistributedOperator(csr, mesh)             # shard once
        a64 = torch.as_tensor(a, dtype=torch.float64, device=csr.device)
        print(f"n={n}  shards={mesh.shape['rows']}  device={csr.device}")

        rng = np.random.default_rng(0)
        for req in range(3):   # serve: repeated RHS against resident shards
            b = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                                device=csr.device)
            x = op.solve_pcg(b, iters=60).double()
            res = float(torch.linalg.vector_norm(a64 @ x - b.double())
                        / torch.linalg.vector_norm(b.double()))
            print(f"request {req}: rel residual {res:.2e}")
        ritz = op.eigen_values(k=16).double().cpu().numpy()
        print(f"spectral bounds ~[{ritz[0]:.3f}, {ritz[-1]:.3f}], "
              f"cond ~{ritz[-1] / ritz[0]:.1f}")


if __name__ == "__main__":
    main()
