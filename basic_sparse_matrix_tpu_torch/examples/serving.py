"""Serving-shaped example: prepare a sparse operator once, reuse it.

Counterpart of the JAX package's ``examples/serving.py``. Production
deployments solve against one matrix many times (time stepping, multiple
load cases, online serving). ``SparseOperator`` / ``prepare_direct`` build
the ordering, the factorization (the banded → supernodal → scatter-list
ladder) and the triangular-solve schedules once; each later ``solve`` runs
only device work. The residual of each solve is computed on the device and
only its maximum is read back.

Run: ``python -m basic_sparse_matrix_tpu_torch.examples.serving [--k 64]
[--n-rhs 8] [--repeats 5] [--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch


def laplacian_2d(k: int):
    """The 5-point Laplacian on a k×k grid as COO arrays."""
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    rid = (ii * k + jj).ravel()
    rows, cols, vals = [rid], [rid], [np.full(k * k, 4.0, np.float32)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = ((0 <= ii + di) & (ii + di < k)
              & (0 <= jj + dj) & (jj + dj < k)).ravel()
        rows.append(rid[ok])
        cols.append(((ii + di) * k + (jj + dj)).ravel()[ok])
        vals.append(np.full(int(ok.sum()), -1.0, np.float32))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def device_scope(device):
    """``use_device(device)`` when a device is named, else the configured
    default (the card)."""
    from ..utils.config import use_device

    return use_device(device) if device else contextlib.nullcontext()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--n-rhs", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="e.g. cpu; default: the configured device (card)")
    args = ap.parse_args(argv)

    from .. import CSR, SparseOperator

    with device_scope(args.device):
        n = args.k * args.k
        rows, cols, vals = laplacian_2d(args.k)
        a = CSR.from_coo_arrays((n, n), rows, cols, vals)
        dev = a.device
        op = SparseOperator(a)

        rng = np.random.default_rng(0)
        print(f"n={n}  device={dev}  preparing...", flush=True)
        t0 = time.perf_counter()
        op.solve(torch.as_tensor(rng.standard_normal(
            (n, args.n_rhs)).astype(np.float32), device=dev))
        sync(dev)
        prep_s = time.perf_counter() - t0
        solver = op._ensure_direct()
        print(f"factorization={solver.kind}  first solve (incl. prep) "
              f"{prep_s:.2f}s", flush=True)

        for i in range(args.repeats):
            b = torch.as_tensor(rng.standard_normal(
                (n, args.n_rhs)).astype(np.float32), device=dev)
            t0 = time.perf_counter()
            x = op.solve(b)
            res = float((op.matmul(x) - b).abs().max())
            dt = time.perf_counter() - t0
            print(f"solve {i}: {dt * 1e3:7.1f} ms wall (incl. scalar "
                  f"residual fetch)   max residual {res:.2e}", flush=True)


if __name__ == "__main__":
    main()
