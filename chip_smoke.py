#!/usr/bin/env python3
"""Drive the PyTorch port's two main paths once on one NVIDIA GPU: CSR × dense
SpMM (``mul_dense``) and the sparse direct solver (``prepare_direct`` →
supernodal Cholesky → level-scheduled triangular solves).

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. Device: the card's name and ``nvidia-smi``'s name and power limit.
2. Build: the K1 (BSR), K2 (streaming), K3 (run reads) and K4/K5
   (add-back) kernels from ``basic_sparse_matrix_tpu_torch/csrc`` with
   nvcc, one process per source, timed; the ptxas register/spill lines.
3. Kernel vs plain: each kernel and its plain PyTorch version on the card
   at the main path's shapes: max abs/rel error and CUDA-event times.
4. Main path: ``mul_dense`` on three matrices, one per rung of the
   ``spmm_auto`` ladder, each checked against the plain gather/segment sum
   on the card (in row chunks):
   * dense rung — the reference ``sd_mul`` top point: 1000×1000, 900k random
     inserts summed as duplicates, × a 128-column RHS; no kernel;
   * BSR rung (K1) — 32768×32768 with 1% of its 64×256 blocks dense and
     random-normal (≈10.7M stored), × a 512-column RHS;
   * stream rung (K2) — 1M×1M with 32 uniformly random columns per row
     (≈32M stored), × a 512-column RHS (the 1M-row SpMM study config).
   The kernel launch counters are set to 0 right before this phase and read
   right after; each kernel must have been launched by its rung.
5. A small matrix through ``mul_dense`` against a float64 numpy product on
   the host.
6. Solver main path: the 33³ 7-point Laplacian (n = 35,937, the JAX
   package's flagship direct-solver scale) with ``ordering="nd"`` and every
   other setting at its default: ``prepare_direct`` then ``solve`` with 1
   and with 8 right-hand sides. The tier must be "supernodal". The launch
   counters are set to 0 right before and read right after; K3, K4 and K5
   must each have launched, K4 and K5 once per level the schedule routes
   to them. ``b = A·x_true`` for a seeded ``x_true``: the normwise backward
   error must be <= 1e-4 and the forward error <= 1e-3.
7. Kernel vs plain for K3, K4 and K5 at that schedule's shapes: K3 on the
   largest group's update-read starts, K4 on the largest K4 group's
   slots, K5 on the K5 group's slots (real starts and live lengths,
   seeded values), each against its plain version on the card, then
   timed.
8. Per formulation: at k = 14 (n = 2744), the factor on the card against
   the factor on the CPU (plain versions) under ``supernodal_scatter`` =
   auto, vmem and pallas with ``supernodal_gather="kernel"``, with TF32
   switched on by the caller beforehand: every matmul of the factorization
   must still see TF32 off.

Tolerance on the card: float32 summed in another order than the plain
version, so ``|out - ref| <= 1e-4 * |ref| + 1e-4 * max|ref|``; the run
reads (K3) copy values and must match exactly.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

SEED = 0
RTOL = 1e-4
ATOL_OF_MAX = 1e-4
# Bytes of gathered rows the plain check takes per row chunk.
CHECK_BUDGET_BYTES = 1 << 30


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def sd_mul_matrix(rng, dev):
    """The reference sd_mul bench's top point (1000×1000, 900k inserts,
    values 0..254, duplicates summed) × a 1000×128 RHS of 0..254."""
    from basic_sparse_matrix_tpu_torch import CSR

    n, inserts = 1000, 900_000
    a = CSR.from_coo_arrays(
        (n, n), rng.integers(0, n, inserts), rng.integers(0, n, inserts),
        rng.integers(0, 255, inserts).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.integers(0, 255, (n, 128)).astype(np.float32),
                        device=dev)
    return a, b


def block_sparse_matrix(rng, dev, gen):
    """32768×32768, 1% of the 64×256 blocks dense random-normal, × a
    32768×512 normal RHS."""
    from basic_sparse_matrix_tpu_torch import CSR

    n, bm, bk = 32768, 64, 256
    nrb, ncb = n // bm, n // bk
    picked = rng.choice(nrb * ncb, size=(nrb * ncb) // 100, replace=False)
    br, bc = picked // ncb, picked % ncb
    r = (br[:, None, None] * bm + np.arange(bm)[None, :, None])
    c = (bc[:, None, None] * bk + np.arange(bk)[None, None, :])
    r, c = np.broadcast_arrays(r, c)
    vals = rng.standard_normal(r.size).astype(np.float32)
    a = CSR.from_coo_arrays((n, n), r.ravel(), c.ravel(), vals, device=dev)
    b = torch.randn((n, 512), generator=gen, device=dev)
    return a, b


def hypersparse_matrix(rng, dev, gen):
    """1M×1M with 32 uniformly random columns per row, × a 1M×512 normal
    RHS."""
    from basic_sparse_matrix_tpu_torch import CSR

    n, per = 1_000_000, 32
    rows = np.repeat(np.arange(n), per)
    cols = rng.integers(0, n, n * per)
    vals = rng.standard_normal(n * per).astype(np.float32)
    a = CSR.from_coo_arrays((n, n), rows, cols, vals, device=dev)
    b = torch.randn((n, 512), generator=gen, device=dev)
    return a, b


def plain_spmm(a, b) -> torch.Tensor:
    """The gather/segment sum on the card, in row chunks whose gathered
    rows stay under CHECK_BUDGET_BYTES."""
    indptr = a.numpy()[0]
    out = torch.zeros((a.rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    per_entry = b.shape[1] * 4
    r0 = 0
    while r0 < a.rows:
        limit = indptr[r0] + max(CHECK_BUDGET_BYTES // per_entry, 1)
        r1 = max(int(np.searchsorted(indptr, limit, side="right")) - 1,
                 r0 + 1)
        r1 = min(r1, a.rows)
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        g = b.index_select(0, a.indices[e0:e1]) \
            * a.values[e0:e1].float().unsqueeze(1)
        seg = torch.repeat_interleave(
            torch.arange(r1 - r0, device=b.device),
            torch.diff(a.indptr[r0: r1 + 1]).long(), output_size=e1 - e0)
        out[r0:r1].index_add_(0, seg, g)
        r0 = r1
    return out


def compare(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Raise unless ``out`` matches ``ref`` within the stated tolerance;
    return the max abs error."""
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite values")
    diff = (out - ref).abs()
    ref_max = float(ref.abs().max()) if ref.numel() else 0.0
    bound = RTOL * ref.abs() + ATOL_OF_MAX * ref_max
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = max_abs / ref_max if ref_max else 0.0
    if not bool((diff <= bound).all()):
        raise AssertionError(f"{name}: max abs err {max_abs:.3e} "
                             f"(rel {max_rel:.3e}) exceeds tolerance")
    log(f"  {name}: max abs err {max_abs:.3e}, rel to max|ref| "
        f"{max_rel:.3e}, ok")
    return max_abs


# ---- the direct solver ----------------------------------------------------
SOLVER_K = 33        # 33³ Laplacian, n = 35,937
FORMULATION_K = 14   # 14³ Laplacian, n = 2744
BACKWARD_ERR_MAX = 1e-4
FORWARD_ERR_MAX = 1e-3


def laplacian_3d(k: int):
    """The 7-point Laplacian on a k×k×k grid as COO arrays (n = k³)."""
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def kernel_modules():
    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel

    return {"spmm_bsr": spmm_kernel, "spmm_stream": stream_kernel,
            "runs_read": runs_read, "addback_resident": addback_resident,
            "panel_addback": panel_addback}


def zero_launches() -> None:
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in kernel_modules().items()}


def set_solver_config(**fields) -> None:
    import dataclasses

    from basic_sparse_matrix_tpu_torch.utils import config

    config.set_config(dataclasses.replace(config.get_config(), **fields))


def solver_main_path(dev) -> dict:
    """Phase 6: prepare_direct + solves on the 33³ Laplacian under
    ordering="nd"; returns the solver and the launch counts of the run."""
    from basic_sparse_matrix_tpu_torch import CSR, prepare_direct
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.runtime import symbolic

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    rng = np.random.default_rng(SEED + 2)
    x_true = rng.standard_normal((n, 8))
    b_host = np.zeros((n, 8))
    np.add.at(b_host, r, v[:, None].astype(np.float64) * x_true[c])
    b8 = torch.as_tensor(b_host.astype(np.float32), device=dev)
    b1 = b8[:, 0].contiguous()
    set_solver_config(ordering="nd")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    solver = prepare_direct(a)
    setup_s = time.perf_counter() - t0
    solve_ms, xs = {}, {}
    for name, b in (("1 rhs", b1), ("8 rhs", b8)):
        solve_ms[name] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs[name] = solver.solve(b)
            torch.cuda.synchronize()
            solve_ms[name].append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"solver main path: n {n}, kind {solver.kind}, native symbolic "
        f"{symbolic.native_lib() is not None} {symbolic.NATIVE_ERROR or ''}")
    if solver.kind != "supernodal":
        raise AssertionError(f"tier {solver.kind!r}, expected supernodal")
    sched = solver.sched
    t = solver.timings
    log(f"  set-up {setup_s:.3f} s host clock: order {t['order']:.3f} s, "
        f"analyze {t['analyze']:.3f} s, numeric {t['numeric'] * 1e3:.1f} ms "
        f"(synchronised), assemble {t['assemble']:.3f} s, solve schedules "
        f"{t['schedules']:.3f} s")
    log(f"  schedule: nnz_l {sched.nnz_l}, {sched.n_groups} groups, "
        f"avg panel width {sched.avg_panel_width:.2f}, kread {sched.kread}, "
        f"fwd levels {solver._fwd.n_levels}, bwd levels "
        f"{solver._bwd.n_levels}, solve tables "
        f"{(solver._fwd.nbytes + solver._bwd.nbytes) / 2**20:.1f} MiB")
    for name, times in solve_ms.items():
        log(f"  solve {name}: " + " / ".join(f"{ms:.2f}" for ms in times)
            + " ms host clock (synchronised)")
    log(f"  peak device memory {peak / 2**30:.3f} GiB")
    levels = {m: 0 for m in ("vmem", "pallas")}
    for gi in range(sched.n_groups):
        mode = sn._group_delta(sched, gi, "auto")
        if mode in levels:
            levels[mode] += int(sched.tabs[gi][0].shape[0])
    log(f"  launches {launches}; levels routed to K4 {levels['vmem']}, "
        f"to K5 {levels['pallas']}")
    if launches["runs_read"] < sched.n_groups:
        raise AssertionError("K3 did not read for every group")
    if (launches["addback_resident"], launches["panel_addback"]) != (
            levels["vmem"], levels["pallas"]) or not (
            levels["vmem"] and levels["pallas"]):
        raise AssertionError("K4/K5 launches do not match the routing")

    # b = A·x_true: normwise backward and forward errors, in float64.
    a_inf = float(np.bincount(r, np.abs(v.astype(np.float64)), n).max())
    for name, xt, bh in (("1 rhs", x_true[:, :1], b_host[:, :1]),
                         ("8 rhs", x_true, b_host)):
        x = xs[name]
        xh = x.double().cpu().numpy().reshape(n, -1)
        if xh.shape != xt.shape or not np.isfinite(xh).all():
            raise AssertionError(f"solve {name}: bad output {xh.shape}")
        res = bh.copy()
        np.add.at(res, r, -v[:, None].astype(np.float64) * xh[c])
        bwd = max(np.abs(res[:, j]).max()
                  / (a_inf * np.abs(xh[:, j]).max() + np.abs(bh[:, j]).max())
                  for j in range(xh.shape[1]))
        fwd = max(np.abs(xh[:, j] - xt[:, j]).max() / np.abs(xt[:, j]).max()
                  for j in range(xh.shape[1]))
        log(f"  solve {name}: backward error {bwd:.3e} (limit "
            f"{BACKWARD_ERR_MAX:g}), forward error {fwd:.3e} (limit "
            f"{FORWARD_ERR_MAX:g})")
        if not (bwd <= BACKWARD_ERR_MAX and fwd <= FORWARD_ERR_MAX):
            raise AssertionError(f"solve {name}: errors over the limits")
    return {"solver": solver, "launches": launches}


def padded_factor(solver) -> torch.Tensor:
    """The factor's flat CSC values with the zero padding
    factorize_supernodal gives them under the default configuration (the
    CSR of L holds them by row; the schedule's pattern gives the order)."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    sched = solver.sched
    pad = 1 + sn._win_pad(sched) + sn._pallas_pad(sched, "auto")
    csc_rows, csc_cols = sched.l_pattern
    indptr, indices, values = solver._l.numpy()
    key_csr = np.repeat(np.arange(sched.n), np.diff(indptr)) * sched.n \
        + indices
    flat = values[np.searchsorted(key_csr, csc_rows * sched.n + csc_cols)]
    out = torch.zeros(sched.nnz_l + pad, device=solver.device)
    out[: sched.nnz_l] = torch.as_tensor(flat, device=solver.device)
    return out


def live_rows(tnr, twd, tcp, rows_len, shape, gen):
    """Seeded values laid out as a group's real add-back rows: slot (s, w)
    of a live column holds the column's storage run (``tnr[s] - w``
    elements, the rect rows w.. of its panel) and zeros after it."""
    st, wt = tcp.shape
    q = torch.arange(rows_len, device=tcp.device)
    w = torch.arange(wt, device=tcp.device)
    run = (tnr[:, None] - w[None, :]).clamp(min=0)            # (St, Wt)
    live = (w[None, :] < twd[:, None])[:, :, None] & (
        q[None, None, :] < run[:, :, None])
    vals = torch.randn((st, wt, rows_len), generator=gen,
                       device=tcp.device)
    out = torch.zeros(shape, device=tcp.device)
    out[:st, :wt] = torch.where(live, vals, 0.0)
    return out


def time_pair(kern, plain, iters: int):
    """Plain, kernel, kernel, plain CUDA-event medians; returns (kernel
    ms, plain ms, the four medians)."""
    from basic_sparse_matrix_tpu_torch.runtime.timing import cuda_time_ms

    ms_p1 = cuda_time_ms(plain, warmup=1, iters=iters)
    ms_k1 = cuda_time_ms(kern, warmup=2, iters=iters)
    ms_k2 = cuda_time_ms(kern, warmup=0, iters=iters)
    ms_p2 = cuda_time_ms(plain, warmup=0, iters=iters)
    return min(ms_k1, ms_k2), min(ms_p1, ms_p2), (ms_p1, ms_k1, ms_k2, ms_p2)


def solver_kernels_vs_plain(solver, gen) -> list:
    """Phase 7: K3, K4 and K5 against their plain versions at the main
    path's shapes."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3

    sched = solver.sched
    scratch = sched.nnz_l
    lvals = padded_factor(solver)
    tab = sn._TABLE_INDEX
    out = []

    # K3: the update reads (A operand: runs of I) of the group with the
    # most run slots under the class cap.
    def slots(gi):
        _, u, w = sched.tabs[gi][tab["upd_base"]].shape
        return u * w
    cands = [gi for gi in range(sched.n_groups)
             if slots(gi) <= sn._KREAD_CR_CAP]
    gi = max(cands, key=lambda g: slots(g) * sn._kread_lpad(
        sched.tabs[g][tab["upd_irows"]].shape[2]))
    base = sched.tabs[gi][tab["upd_base"]][0].long()
    L = int(sched.tabs[gi][tab["upd_irows"]].shape[2])
    lp = sn._kread_lpad(L)
    stf = torch.where(base != scratch, base, -1).reshape(-1).to(torch.int32)
    got, ref = k3.runs_read(lvals, stf, lp), k3.runs_read_reference(
        lvals, stf, lp)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("runs_read kernel differs from its plain version")
    log(f"  runs_read: group {gi}, {stf.numel()} runs "
        f"({int((stf >= 0).sum())} live) of L {L} read as l_pad {lp}: "
        f"equal to the plain version")
    ms, plain_ms, four = time_pair(lambda: k3.runs_read(lvals, stf, lp),
                                   lambda: k3.runs_read_reference(
                                       lvals, stf, lp), 20)
    moved = 2 * stf.numel() * lp * 4
    log(f"  runs_read: kernel {four[1]:.4f} / {four[2]:.4f} ms, plain "
        f"{four[0]:.4f} / {four[3]:.4f} ms; {moved / ms / 1e6:.1f} GB/s by "
        f"2·runs·l_pad·4 bytes")
    out.append(("runs_read", "basic_sparse_matrix_tpu_torch/csrc/runs_read.cu",
                "basic_sparse_matrix_tpu/ops/pallas/runs_read.py:98",
                0.0, ms, plain_ms))

    # K4 and K5: the add-back operands of one group each, level 0.
    def targets(gi):
        return tuple(sched.tabs[gi][tab[name]][0].long()
                     for name in ("tgt_cp", "tgt_nrows", "tgt_w"))
    modes = [sn._group_delta(sched, g, "auto") for g in range(sched.n_groups)]
    g4 = max((g for g in range(sched.n_groups) if modes[g] == "vmem"),
             key=lambda g: sched.tabs[g][tab["tgt_cp"]][0].numel())
    tcp, tnr, twd = targets(g4)
    cq, col_pad = sched.vmem_shape[g4]
    st, wt = tcp.shape
    psh2 = live_rows(tnr, twd, tcp, col_pad, (st, wt, col_pad), gen)
    psh2 = torch.nn.functional.pad(psh2.reshape(st * wt, col_pad),
                                   (0, 0, 0, cq - st * wt))
    wv = torch.arange(wt, device=tcp.device)[None, :]
    tcpf = torch.nn.functional.pad(
        torch.where(wv < twd[:, None], tcp, -1).reshape(-1),
        (0, cq - st * wt), value=-1).to(torch.int32)
    k4_args = (psh2, tcpf)
    k4_desc = (f"group {g4}, (CQ, col_pad) = ({cq}, {col_pad}), "
               f"{int((tcpf >= 0).sum())} live slots")

    g5 = next(g for g in range(sched.n_groups) if modes[g] == "pallas")
    tcp, tnr, twd = targets(g5)
    st, wt = tcp.shape
    col_len = sn._colq(sched.delta_rmax[g5]) + 1024
    st_q, wt_q = sn._pow2(st), sn._pow2(wt)
    psh = live_rows(tnr, twd, tcp, col_len, (st_q, wt_q, col_len), gen)
    tcp_q = torch.nn.functional.pad(tcp, (0, wt_q - wt, 0, st_q - st))
    twd_q = torch.nn.functional.pad(twd, (0, st_q - st))
    k5_args = (psh, tcp_q.to(torch.int32), twd_q.to(torch.int32))
    k5_desc = (f"group {g5}, psh {tuple(psh.shape)} (St {st}, Wt {wt}), "
               f"{int(twd.sum())} live columns")

    for name, mod, kern, plain, args, desc, replaces in (
            ("addback_resident", k4, k4.addback_resident,
             k4.addback_resident_reference, k4_args, k4_desc,
             "basic_sparse_matrix_tpu/ops/pallas/addback_resident.py:106"),
            ("panel_addback", k5, k5.panel_addback,
             k5.panel_addback_reference, k5_args, k5_desc,
             "basic_sparse_matrix_tpu/ops/pallas/panel_addback.py:135")):
        got = kern(lvals.clone(), *args)
        torch.cuda.synchronize()
        err = compare(f"{name} kernel vs plain ({desc})", got,
                      plain(lvals.clone(), *args))
        del got
        work = lvals.clone()
        ms, plain_ms, four = time_pair(lambda: kern(work, *args),
                                       lambda: plain(work, *args), 20)
        nz = int((args[0] != 0).sum())
        log(f"  {name}: kernel {four[1]:.4f} / {four[2]:.4f} ms, plain "
            f"{four[0]:.4f} / {four[3]:.4f} ms; {nz} nonzero row elements, "
            f"{nz / ms / 1e6:.1f} G atomic adds/s, rows {args[0].numel() * 4 / 2**20:.1f} MiB")
        out.append((name, "basic_sparse_matrix_tpu_torch/csrc/addback.cu",
                    replaces, err, ms, plain_ms))
    return out


class MatmulTf32Probe(TorchFunctionMode):
    """Counts the matmul-family and dense-factor calls made under it, and
    how many of them ran with TF32 allowed."""

    def __init__(self):
        super().__init__()
        self.calls = 0
        self.tf32 = 0
        self.funcs = {torch.einsum, torch.matmul, torch.bmm, torch.mm,
                      torch.Tensor.__matmul__, torch.Tensor.matmul,
                      torch.Tensor.bmm, torch.linalg.cholesky_ex,
                      torch.linalg.solve_triangular}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.funcs:
            self.calls += 1
            self.tf32 += int(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def formulations_on_card(dev) -> None:
    """Phase 8: the k = 14 factor on the card against the CPU under three
    scatter formulations, with TF32 allowed by the caller."""
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops import reorder

    n, r, c, v = laplacian_3d(FORMULATION_K)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for scatter in ("auto", "vmem", "pallas"):
            set_solver_config(supernodal_gather="kernel",
                              supernodal_scatter=scatter)
            lv = {}
            for d in ("cpu", dev):
                a = CSR.from_coo_arrays((n, n), r, c, v, device=d)
                a = reorder.permute_symmetric(a, reorder.nd_permutation(a))
                sched = sn.analyze_supernodal(a, relax=8)
                before = read_launches()
                probe = MatmulTf32Probe()
                with probe:
                    lv[str(d)] = sn.factorize_supernodal(sched, a.values)
                after = read_launches()
            torch.cuda.synchronize()
            got = {k: after[k] - before[k] for k in after}
            modes = {sn._group_delta(sched, gi, scatter)
                     for gi in range(sched.n_groups)}
            want = {"runs_read": True, "addback_resident": "vmem" in modes,
                    "panel_addback": "pallas" in modes}
            compare(f"k={FORMULATION_K} factor, scatter {scatter}, card vs "
                    f"cpu (launches K3 {got['runs_read']}, K4 "
                    f"{got['addback_resident']}, K5 {got['panel_addback']}; "
                    f"{probe.calls} matmul/factor calls, {probe.tf32} with "
                    f"TF32)", lv[str(dev)], lv["cpu"].to(dev))
            if any((got[k] > 0) != w for k, w in want.items()):
                raise AssertionError(f"scatter {scatter}: launches {got}, "
                                     f"expected {want}")
            if probe.calls == 0 or probe.tf32:
                raise AssertionError("TF32 was on during the factorization")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        set_solver_config(supernodal_gather="auto",
                          supernodal_scatter="auto")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False); nothing was run")
    from basic_sparse_matrix_tpu_torch import mul_dense
    from basic_sparse_matrix_tpu_torch.ops import ell as ell_mod
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
    from basic_sparse_matrix_tpu_torch.runtime import cuda_kernels
    from basic_sparse_matrix_tpu_torch.runtime.timing import cuda_time_ms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} | nvidia-smi name, power.limit: {smi}")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    cuda_kernels.load()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_kernels.BUILD_SECONDS:.2f} s)")
    for line in (cuda_kernels.BUILD_LOG or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- matrices and host plans ------------------------------------------
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    a_dense, b_dense = sd_mul_matrix(rng, dev)
    a_bsr, b_bsr = block_sparse_matrix(rng, dev, gen)
    a_st, b_st = hypersparse_matrix(rng, dev, gen)
    torch.cuda.synchronize()
    log(f"matrices built on the host and uploaded: "
        f"{time.perf_counter() - t0:.2f} s")
    for name, a in (("dense", a_dense), ("bsr", a_bsr), ("stream", a_st)):
        log(f"  {name}: {a.rows}x{a.cols}, stored {a.stored}, "
            f"density {a.get_density():.3e}")

    t0 = time.perf_counter()
    bsr = k1.cached_bsr(a_bsr)
    log(f"host BSR plan: {time.perf_counter() - t0:.2f} s; bm,bk = "
        f"{bsr.bm},{bsr.bk}, {bsr.nblocks} blocks, fill "
        f"{a_bsr.stored / (bsr.nblocks * bsr.bm * bsr.bk):.3f}, "
        f"{bsr.blocks.numel() * 4 / 2**20:.1f} MiB")
    t0 = time.perf_counter()
    plan = k2.stream_plan_from_ell(ell_mod.cached_ell(a_st),
                                   int(b_st.shape[1]))
    log(f"host stream plan (ELL + cell binning): "
        f"{time.perf_counter() - t0:.2f} s; tile_m {plan.tile_m}, tile_k "
        f"{plan.tile_k}, {plan.n_rt}x{plan.n_kt} cells, cellmax "
        f"{plan.cellmax}, pad_factor {plan.pad_factor:.4f}, "
        f"{plan.nbytes / 2**20:.1f} MiB")

    # ---- 3. kernel vs plain at the main path's shapes ---------------------
    log("kernel vs plain on the card:")
    kernels = []
    for name, src, replaces, kern, plain, iters in (
            ("spmm_bsr", "basic_sparse_matrix_tpu_torch/csrc/spmm_bsr.cu",
             "basic_sparse_matrix_tpu/ops/pallas/spmm_kernel.py:178",
             lambda: k1.spmm_bsr(bsr, b_bsr),
             lambda: k1.spmm_bsr_reference(bsr, b_bsr), 10),
            ("spmm_stream",
             "basic_sparse_matrix_tpu_torch/csrc/spmm_stream.cu",
             "basic_sparse_matrix_tpu/ops/pallas/stream_kernel.py:178",
             lambda: k2.spmm_stream(plan, b_st),
             lambda: k2.spmm_stream_reference(plan, b_st), 5)):
        out_k = kern()
        torch.cuda.synchronize()
        out_p = plain()
        err = compare(f"{name} kernel vs plain", out_k, out_p)
        del out_k, out_p
        ms_p1 = cuda_time_ms(plain, warmup=1, iters=iters)
        ms_k1 = cuda_time_ms(kern, warmup=2, iters=iters)
        ms_k2 = cuda_time_ms(kern, warmup=0, iters=iters)
        ms_p2 = cuda_time_ms(plain, warmup=0, iters=iters)
        ms, plain_ms = min(ms_k1, ms_k2), min(ms_p1, ms_p2)
        log(f"  {name}: kernel {ms_k1:.4f} / {ms_k2:.4f} ms, plain "
            f"{ms_p1:.4f} / {ms_p2:.4f} ms (median of {iters}, "
            f"plain-kernel-kernel-plain)")
        kernels.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    flops = 2 * bsr.nblocks * bsr.bm * bsr.bk * b_bsr.shape[1]
    log(f"  spmm_bsr: {flops / kernels[0]['ms'] / 1e9:.2f} TFLOP/s over the "
        f"padded blocks")
    gather_bytes = plan.nnz * (8 + 4 * b_st.shape[1]) \
        + plan.rows * b_st.shape[1] * 4
    log(f"  spmm_stream: {gather_bytes / kernels[1]['ms'] / 1e6:.1f} GB/s by "
        f"the gather byte model nnz*(8+4n) + rows*n*4")

    # ---- 4. main path through mul_dense ---------------------------------
    log("main path (mul_dense, twice per rung: the first call includes "
        "one-time host work such as densifying or the BSR fill count):")
    checks = []
    zero_launches()
    for name, a, b, want in (("dense", a_dense, b_dense, (0, 0)),
                             ("bsr", a_bsr, b_bsr, (2, 0)),
                             ("stream", a_st, b_st, (0, 2))):
        before = (k1.LAUNCHES, k2.LAUNCHES)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mul_dense(a, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1])
        log(f"  {name} rung: first {times[0] * 1e3:.3f} ms, second "
            f"{times[1] * 1e3:.3f} ms host clock (dispatch included), "
            f"launches K1 {got[0]}, K2 {got[1]}")
        if got != want:
            raise AssertionError(f"{name} rung launched (K1, K2) = {got}, "
                                 f"expected {want}")
        checks.append((name, a, b, out))
    launches = read_launches()
    if any(launches[k] for k in ("runs_read", "addback_resident",
                                 "panel_addback")):
        raise AssertionError(f"mul_dense launched a solver kernel: {launches}")
    launches = (launches["spmm_bsr"], launches["spmm_stream"])
    for name, a, b, out in checks:
        compare(f"{name} rung vs plain gather/segment", out, plain_spmm(a, b))
    del checks, out
    kernels[0]["launches"], kernels[1]["launches"] = launches
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched by the "
                                 f"main path")

    # ---- 5. small input against numpy on the host -------------------------
    from basic_sparse_matrix_tpu_torch import CSR

    small = np.random.default_rng(SEED + 1)
    d = ((small.random((257, 300)) < 0.05)
         * small.standard_normal((257, 300))).astype(np.float32)
    bs = small.standard_normal((300, 40)).astype(np.float32)
    out = mul_dense(CSR.from_dense(d, device=dev),
                    torch.as_tensor(bs, device=dev))
    compare("small mul_dense vs numpy float64",
            out, torch.as_tensor(d.astype(np.float64) @ bs,
                                 device=dev).float())
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del a_dense, b_dense, a_bsr, b_bsr, a_st, b_st, bsr, plan
    torch.cuda.empty_cache()

    # ---- 6. solver main path ------------------------------------------
    main = solver_main_path(dev)

    # ---- 7. K3-K5 kernel vs plain at the solver's shapes -----------------
    log("solver kernels vs plain on the card:")
    for name, src, replaces, err, ms, plain_ms in solver_kernels_vs_plain(
            main["solver"], gen):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main["launches"][name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    del main

    # ---- 8. per-formulation factors, card vs CPU ------------------------
    log(f"per-formulation factors at k={FORMULATION_K}:")
    formulations_on_card(dev)
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched by its "
                                 f"main path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
