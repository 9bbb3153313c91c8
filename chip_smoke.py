#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: CSR × dense
SpMM (``mul_dense``), the sparse direct solver (``prepare_direct`` →
supernodal Cholesky → level-scheduled triangular solves), the rest of
``models/`` through the serving wrapper ``SparseOperator``: every
``DirectSolver`` tier (supernodal, banded scan, BCR, scatter-list), IC(0)-PCG,
Lanczos, Chebyshev, dense Cholesky and TSQR; and the sparse × sparse algebra
(``a + b``, ``a - b``, ``a * s``, ``spgemm``, ``matmul_sparse``), the file
round trips and the per-entry FMA probe (K6); and the distributed layer
(``parallel/``) on logical shards of the one card and over NCCL at world
size 1; and batched values (many numeric systems of one pattern through
one schedule: factorizations, triangular solves, SpMM).

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. Device: the card's name and ``nvidia-smi``'s name and power limit.
2. Build: the K1 (BSR), K2 (streaming: tile and sliced kernels), K3 (run
   reads), K4/K5 (add-back: span and rect entries), K6 (per-entry FMA)
   and K7 (the triangular solve's level step) kernels from
   ``basic_sparse_matrix_tpu_torch/csrc`` with nvcc, one process per
   source, timed; the ptxas register/spill lines.
3. Kernel vs plain: each kernel and its plain PyTorch version on the card
   at the main path's shapes: max abs/rel error and CUDA-event times. K1
   also at the other two ``pick_tiles`` shapes, (256, 512) and (8, 128),
   on operands built straight through ``make_bsr`` (each > 100 MB of
   blocks, B over the 50 MB L2, N = 512), with TFLOP/s over live and over
   all blocks, its launch configuration (registers, shared memory, spill
   bytes, blocks per SM), its library yardstick ``torch.sparse.mm`` of a
   ``sparse_csr_tensor`` holding the live blocks (built untimed) and, at
   each shape, the first rows of its
   HIGHEST output against a float64 product (``max|err| <= 1e-5 ·
   max|ref|``). K2: BOTH kernels of ``spmm_stream`` (tile and sliced)
   against ``spmm_stream_reference`` at the main shape, timed in turns
   (plain-tile-sliced-sliced-tile-plain, median of 5 with min and max); the
   sliced kernel must be bitwise equal across two calls and be the one
   ``spmm_stream`` dispatches to there; the card's gather rate for 32-byte
   pieces by array size; a ``spmm_stream`` call on
   a B that fits the L2 budget and on a plan with several k tiles, which
   the dispatch sends to the tile kernel, each held to the plain version.
   The ``spmm_stream`` entry of ``kernels`` reports the dispatched kernel
   and names it.
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
   right after; each kernel must have been launched by its rung, and the
   stream rung must have launched the sliced K2 kernel twice. The three
   operands are built with no ``device`` argument and must lie on the card
   (the configured default device).
5. A small matrix through ``mul_dense`` against a float64 numpy product on
   the host.
6. Solver main path: the 33³ 7-point Laplacian (n = 35,937, the JAX
   package's flagship direct-solver scale) with ``ordering="nd"`` and every
   other setting at its default: ``prepare_direct`` then ``solve`` with 1
   and with 8 right-hand sides. The tier must be "supernodal". The launch
   counters are set to 0 right before and read right after; K3 and the
   add-back's rect entry must have launched, the rect entry (through
   ``addback_resident.addback_rects``, the one add-back wrapper the
   factorization calls) once per level the schedule routes to the add-back
   (``"rects"``), on groups that the JAX package sends to its K4 and to its
   K5 alike. ``b = A·x_true`` for a seeded ``x_true``: the normwise backward
   error must be <= 1e-4 and the forward error <= 1e-3.
7. Kernel vs plain for K3, K4 and K5 at that schedule's shapes: K3 on the
   largest group's update-read starts; the add-back's span entry on the
   slots of the largest group the JAX package sends to K4 and of the first
   it sends to K5, sheared as that package builds them (real starts and
   live lengths, seeded values); its rect entry (what the main path
   launches on the card) on the same two groups' ``tcp``, ``tnr``, ``twd``
   with seeded rects; each against its plain version on the card
   (``|d| <= 1e-5 * max(1, max|ref|)`` for the add-back: atomic adds in
   another order), then timed in turns plain-kernel-kernel-plain, at the
   host's pace and with the launches queued behind a spin kernel (device
   only); each beside the one PyTorch call for the same function, an
   ``index_add_`` with its positions built (the span entry's over the live
   spans, the rect entry's the masked one of
   ``supernodal_scatter="delta"``); K3 beside one gather of overlapping
   windows, ``lvals.unfold(0, l_pad, 1)[starts]``. The ``kernels`` rows of
   K4 and K5 carry the rect entry's numbers, the kernel the main path
   launches; their launches are the two wrappers' measured counts: K4's
   every rect launch (one a routed level), K5's 0 (its span wrapper is off
   the main path). The span entry's numbers ride along under
   ``span_entry``. Each bound counts what the function needs: tables,
   nonzero elements, touched factor values, not a dead slot's row.
8. Per formulation: at k = 14 (n = 2744), the factor on the card against
   the factor on the CPU (plain versions) under ``supernodal_scatter`` =
   auto, vmem and pallas with ``supernodal_gather="kernel"``, with TF32
   switched on by the caller beforehand: every matmul of the factorization
   must still see TF32 off; K3 and the rect entry launch, the span entries
   never.
9. Serving wrapper, default config: ``SparseOperator(a)`` on the 33³
   Laplacian; ``solve`` with 1 (twice: with set-up, then from the cached
   factor) and 8 right-hand sides. The tier must be "supernodal" (``auto``
   picks ND there) and K3 and the rect entry must launch (counts set to 0
   right before, read right after); the same error limits as phase 6.
   ``op.matmul`` on an 8-column RHS against the plain gather/segment sum.
10. Banded tiers at full size: the same matrix under ``ordering="rcm"``
    (block 840, 43 block rows, BCR pads to 64): ``kind == "banded-bcr"``,
    then ``banded_solver="scan"`` and ``kind == "banded"``; each solves 1
    and 8 right-hand sides under the same limits; set-up by phase, ms per
    solve, peak device memory.
11. Scatter-list tier at full size: the Laplacian of a seeded random
    recursive tree plus I at n = 10⁶ (a radial distribution grid's shape)
    under ``ordering="rcm"``: ``kind == "scatter"``, the same limits; the
    schedule's levels, triples, ragged table bytes and the bytes the JAX
    package's padded tables would take.
12. Iterative and spectral path on the 33³ Laplacian: the IC(0) set-up
    (L's pattern levels), timed; ``op.solve_cg`` to ``tol=1e-6`` with the
    relative residual recomputed in float64 on the card (<= 1e-5) and the
    ms per iteration; ``op.eigen_values(32)`` against the analytic
    λ_max = 6(1 + cos(π/34)) (Ritz values lie inside the spectrum; a
    sanity bound of 1e-2 relative, see ``RITZ_MAX_REL``) and λ_min (not
    more than 1e-4 below), ``condition_estimate`` beside the analytic
    467.84; the 32 Ritz values from one seeded numpy start vector on the
    card against the CPU's (``|d| <= 1e-4·|ref| + 1e-6·max|ref|``);
    ``chebyshev_solve`` with the analytic bounds and 200 iterations
    (relative residual in float64 <= 1e-4), and ``op.solve_chebyshev``
    with Lanczos bounds (printed).
13. Card against CPU at k = 14 (n = 2744), natural order, TF32 switched on
    by the caller and seen off by every matmul: the solutions and factors
    of the BCR, scan and scatter-list tiers (``supernodal_relax=0``,
    banded off) and ``cholesky_auto``'s factor; then ``tsqr`` at
    1,048,576 × 64 (``‖A − QR‖_F/‖A‖_F <= 1e-5``, ``max|QᵀQ − I| <=
    1e-4`` in float64) timed beside ``torch.linalg.qr`` on the same
    operand.
14. ss_add: 1000², two operands of 900,000 inserts each (≈ 593k stored):
    ``a + b``, ``a - b``, ``a * 3`` against the dense sums on the card;
    the first call (host plan) and the cached call timed apart; then
    ``(a + b) - b``, whose left operand is capacity padded, through the
    key-space fallback.
15. ss_mul, masked-dense: 1000², 500,000 inserts each: ``spgemm(a, b)``
    against ``a.todense() @ b.todense()`` in float64 on the card.
16. ss_mul, planned: n = 100,000 with 500,000 inserts each (past the dense
    budget, so ``spgemm`` takes ``spgemm_planned``), and the long-row case
    (A 200,000 inserts, B 64 entries a row). Sampled columns of C against
    the plain gather/segment sum of A with those columns of B; nnz(C) and
    the whole pattern against a host Gustavson product (scipy's SpGEMM on
    all-ones operands). Plan seconds, numeric ms, expansion, nnz(C), peak
    memory.
17. ``SparseOperator.matmul_sparse`` on the 33³ Laplacian (A·A, 25 entries
    a row inside) against ``op.matmul`` of densified columns of A; and
    ``write_matrix_market`` → ``read_matrix_market`` of that matrix through
    a temporary directory, entry for entry. (``save_direct`` →
    ``load_direct`` → solve runs in phase 10, on each banded solver, under
    the same error limits.)
18. K6: ``entry_fma`` against ``entry_fma_reference`` at the probe's
    default shape (8192 entries, 4096 rows, 128 lanes), at 512 lanes and
    with every entry in one row (max abs error < 1e-4 of the larger of 1
    and max|ref|); the kernel's, the plain version's and
    ``torch.sparse.mm``'s (COO) times; K6 on K2's own entries (phase 3);
    then the probe (``probes/entry_fma_probe.py``), K6's main path: ns per
    entry beside K2's on the same entries, and beside K2's at its own shape
    from phase 3. The launch counter is set to 0 right before the probe and
    read right after.

19. ``parallel/``, run after phase 5 while the 1M-row operand is resident
    (the counts set to 0 right before, read right after; K2 must launch):
    (a) ``spmm_sharded``, ``spmm_allgather``, ``spmm_ring`` at 4 logical
    shards (``LocalComm``) and ``spmm_ring_2d`` at 2 × 2 on phase 4's
    stream operand, each held to phase 4's ``mul_dense`` result under
    ``compare``'s limits; K2 must launch once per rank and ring step in a
    call and K1 never (every local product on the streaming rung); host
    shard time, first call (host plans), CUDA-event ms a call (median of
    3) beside ``mul_dense``'s, peak memory; (b) ``DistributedOperator``
    on the 33³ Laplacian at 8 logical shards: ``matvec``/``matmul`` (8 rhs) against
    ``SparseOperator``; ``solve_cg`` (110 iterations), ``solve_pcg`` (40)
    to a float64 relative residual <= 1e-5, ``solve_chebyshev`` (150, bounds
    from ``eigen_values(32)``) <= 1e-4; the sharded Ritz extremes (k = 32,
    one seeded v0) within 1e-4·|λ| of the single-device Lanczos;
    ``matmul_sparse(A)`` against ``SparseOperator``'s, pattern entry for
    entry, values within 1e-5 of max|ref|; (c) ``tsqr_sharded`` at 2²⁰ × 64
    on 4 shards (phase 13's limits), timed beside ``tsqr`` and
    ``torch.linalg.qr``; (d) ``spgemm_sharded`` on phase 16's operands at 4
    shards against ``spgemm_planned``; (e) ``spmm_ring`` on (a)'s operand
    and ``solve_cg`` on (b)'s through ``TorchDistComm`` over NCCL at world
    size 1, each bitwise equal to ``LocalComm`` at one shard; (f)
    ``dryrun_multichip(8)`` on the card. Every result must lie on the card;
    NCCL that cannot start fails the smoke.
20. ``parallel/`` direct solvers and BCR, run after phase 18, at full width
    on 4 logical shards (``LocalComm``), each beside the single-device
    function on the same input in the same run: (a) the 33³ Laplacian under
    ``ordering="nd"`` (phase 6's input): ``factorize_supernodal_sharded``
    within 1e-5 of max|ref| of ``factorize_supernodal`` on the same
    schedule (the counts of K3 and the add-back set to 0 right before and
    read right after: K3 must launch and the rect entry once per routed
    level, as in phase 6), then ``solve_sparse_distributed`` forward and
    backward on the assembled factor (schedules built inside) and the same
    solves on schedules built once, at 1 and 8 right-hand sides, under
    phase 6's limits and against the single-device solves; (b) the 10⁶-node
    tree Laplacian + I under ``ordering="rcm"`` (phase 11's input):
    ``factorize_sharded`` against ``factorize``, then the same solves;
    (c) the 33³ Laplacian under ``ordering="rcm"`` (phase 10's input, nb
    840, 43 block rows padded to 64): ``bcr_solve_sharded_csr`` at 1 and 8
    right-hand sides against ``BCRSolver``; (d) at world size 1 over NCCL,
    on the 14³ Laplacian, against ``LocalComm`` at one shard, with torch's
    deterministic algorithms on (a CUDA ``index_add_`` then adds in a fixed
    order instead of with atomics): ``factorize_sharded``,
    ``solve_triangular_sharded``, ``bcr_solve_sharded`` and
    ``build_global_sharded_csr`` + ``spmm_sharded`` bitwise,
    ``factorize_supernodal_sharded`` within 1e-6 of max|ref| (the add-back
    kernel's ``atomicAdd`` may sum in another order); (e) ``dryrun_multichip(8)``,
    the direct and BCR steps included. Set-up by part, ms per
    factorization and per solve beside one device, launches and the peak
    above each part's start are logged; every result must lie on the card.
    The K3, K4 and K5 entries of ``kernels`` carry (a)'s counts as
    ``launches_parallel``.

21. Batched values (one pattern, one symbolic schedule, many numeric
    systems; the port's counterpart of ``jax.vmap`` over the values): (a)
    ``factorize_supernodal`` on phase 6's schedule of the 33³ ND Laplacian
    with Bt = 8 value sets ``A + c_b·I`` (``c_b`` from the seed) at once,
    the counts set to 0 right before and read right after: K3 and the
    add-back's rect entry must launch exactly as often as for one system
    (measured on the first of the 8 single calls that follow); each
    system's batched factor within ``1e-4·max|ref|`` of its single-system
    factor (atomics); then the batched triangular solves on phase 6's
    schedules (``schedule_values`` through ``csr_value_order``), 8
    right-hand sides a system, each system under phase 6's error limits
    and against its own batch-of-one solve; times of the batch against 8
    single calls, peak memory above the part's start; (b) the same on
    phase 11's 10⁶-node tree (scatter-list, Bt = 4); (c) run after phase
    19 while the 1M-row operand is resident: ``mul_dense`` with ``b`` of
    shape (4, 1M, 128), which must launch K2 once (the batch folded into
    512 columns), each block against its own ``mul_dense``; (d)
    ``spmm(a, b, values=V)`` with 8 value sets of the 33³ Laplacian and 8
    right-hand sides against ``spmm`` on each system's CSR. K3 and the
    rect entry with a batch axis (Bt = 8) at phase 7's operands against
    their plain versions and their one-system launches, timed as phase 7
    times them (host-paced turns and device only); the K3, K4 and K5 rows
    of ``kernels`` carry them under ``batched`` (``bt``, ``ms``,
    ``device_ms``, ``plain_ms``, ``bound_ms`` of 8 systems' bytes,
    ``launches`` of (a)'s batched factorization).

22. Compiled loops (``runtime/graphs.py``: each loop captured once as a
    CUDA graph per owner and operand shape, then replayed), each graphed
    path against its eager loop on the same card in the same run: the 33³
    ND supernodal solves at 1 and 8 rhs (phase 6's solver, on fresh
    copies of its schedules so that the first call captures), the batched
    8 × 8 solves of 21(a), the tree scatter solves of phase 11 (each solve
    as ``DirectSolver.solve`` runs it, permutations included), PCG at tol
    1e-6 on phase 12's input in chunks of ``pcg.CHUNK`` iterations (the
    iteration count must equal the eager loop's, float64 residual <=
    1e-5), its replays at chunks of 4, 8 and 16 at tol 1e-6 and 1e-5 (the
    measurement behind ``pcg.CHUNK``; every count equal to the host-read
    loop's), and Chebyshev(200) with the analytic bounds (float64 residual
    <= 1e-4). The eager loop is the same entry point under
    ``eager_loops()`` (PCG's: ``_pcg_loop``, the loop before graphs). Each replay within ``1e-5·max|ref|`` of the eager result and
    under its path's limits. Per path: eager and replay ms (min / median /
    max of 5, in turns), the first call (warm-up, capture, replay) in s,
    the memory the graphs keep (static buffers + private pool) and the
    first call's peak, then (last, since a profiled window slows later
    launch-bound walls) one replay under ``torch.profiler``: its device
    operations (the launches the graph holds) and the device busy share.
    Phase 6 and the other solver phases call the graphed solves too: the
    first solve of each shape there captures.

23. Compiled programs (the numeric phases, Lanczos, the banded and BCR
    solves, the QR iteration; see ``compiled_programs_phase``).

24. The distributed compiled programs of ``parallel/`` (each captured
    through ``parallel/comm.py::compiled``), each against the same call
    under ``eager_loops()`` in turns, on the inputs of phases 19(b) and
    20(a)-(c): (a) ``factorize_supernodal_sharded`` on a copy of phase 6's
    33³ ND schedule at 4 logical shards (the second call captures; within
    1e-5·max|ref| of the single-device factor; a replay holds 20(a)'s eager
    K3 and rect-entry launches by kernel name) and the distributed solves
    on copies of phase 6's triangular schedules at 1 and 8 rhs; (b) the
    same for the 10⁶-node tree's scatter-list phase; (c)
    ``DistributedOperator`` at 8 shards: CG, PCG, Chebyshev (new bounds
    must replay the same graph) and Lanczos(32); (d) ``bcr_solve_sharded``
    on the 33³ RCM blocks at 1 and 8 rhs; (e) over NCCL at world size 1
    every program's capture and replay bit for bit against eager
    ``LocalComm`` at one shard (deterministic algorithms; the supernodal
    factor within 1e-6·max|ref|), the graphs dropped with the
    communicator; (f) ``spmm_ring`` at 4 shards and ``spmm_ring_2d`` at 2 ×
    2 on phase 19's 1M-row operand and B (kept to the end for this), op by
    op as the port runs them, against CUDA graphs of the same calls made
    in the smoke (the measurement behind keeping them op by op). Phase
    19 runs under ``eager_loops()`` and phase 20 runs its sharded calls
    under it, so their numbers stay eager.

25. K7 (``csrc/trsv_level.cu``, the triangular solve's level step; run
    after phase 18): its time at the median level of IC(0) of HPCG's
    operator at 104³ (a wide launch), on the dataflow chain of that
    solve's ~710 wide levels (one launch), on the longest narrow run of the
    32³ nested-dissection factor (one block), and both forward solves,
    each captured in a CUDA graph beside the plain version (four
    operations a level) and the bound; each solve within 1e-5·max|ref| of
    the plain version (``probes/trsv_probe.py::hpcg_rows``). Its row in
    the ``kernels`` line counts phase 6's launches.

Every kernel's line also carries ``bound_ms``, the least time the card
could take: the larger of the bytes the function must move (each input read
once, each output written once; for data-dependent work what this run's data
needs) over 3.35 TB/s and its float32 operations over 67 TFLOP/s (NVIDIA's
H100 SXM data sheet), and which of the two it is.

Tolerance on the card: float32 summed in another order than the plain
version, so ``|out - ref| <= 1e-4 * |ref| + 1e-4 * max|ref|``; the run
reads (K3) copy values and must match exactly.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import tempfile
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
        rng.integers(0, 255, inserts).astype(np.float32))
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
    a = CSR.from_coo_arrays((n, n), r.ravel(), c.ravel(), vals)
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
    a = CSR.from_coo_arrays((n, n), rows, cols, vals)
    b = torch.randn((n, 512), generator=gen, device=dev)
    return a, b


def random_bsr(rng, dev, gen, n, bm, bk, nblocks):
    """An n×n BSR of ``nblocks`` dense random-normal (bm, bk) blocks at
    random distinct positions, built straight through ``make_bsr`` (no
    CSR), × an n×512 normal RHS."""
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1

    nrb, ncb = n // bm, n // bk
    picked = np.sort(rng.choice(nrb * ncb, size=nblocks, replace=False))
    blocks = rng.standard_normal((nblocks, bm, bk), dtype=np.float32)
    bsr = k1.make_bsr(blocks, picked // ncb, picked % ncb, n, n, device=dev)
    return bsr, torch.randn((n, 512), generator=gen, device=dev)


def bsr_head_f64(bsr, b, n_block_rows: int) -> torch.Tensor:
    """The first ``n_block_rows`` block rows of ``A @ b`` in float64 on the
    card, over every stored block."""
    p = int(bsr.brow_ptr[n_block_rows])
    bp = torch.zeros((bsr.padded_cols, b.shape[1]), dtype=torch.float64,
                     device=b.device)
    bp[: b.shape[0]] = b.double()
    panels = bp.view(-1, bsr.bk, b.shape[1])[bsr.block_cols[:p].long()]
    out = torch.zeros((n_block_rows, bsr.bm, b.shape[1]), dtype=torch.float64,
                      device=b.device)
    out.index_add_(0, bsr.block_rows[:p].long(),
                   torch.bmm(bsr.blocks[:p].double(), panels))
    return out.view(-1, b.shape[1])[: bsr.rows]


# Float32 accuracy of K1 under HIGHEST, against the float64 product.
K1_F64_REL = 1e-5


def k1_vs_plain(bsr, b, shape_name: str, iters: int) -> tuple:
    """K1 against its plain version and a float64 head slice at one
    shape; returns (max abs err, kernel ms, plain ms)."""
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1

    out = k1.spmm_bsr(bsr, b)
    torch.cuda.synchronize()
    err = compare(f"spmm_bsr kernel vs plain, {shape_name}", out,
                  k1.spmm_bsr_reference(bsr, b))
    nbr = min(bsr.n_block_rows, max(1, 512 // bsr.bm))
    ref = bsr_head_f64(bsr, b, nbr)
    head = out[: ref.shape[0]].double()
    f64_err = float((head - ref).abs().max())
    ref_max = float(ref.abs().max())
    log(f"  spmm_bsr {shape_name}: first {ref.shape[0]} rows vs float64: "
        f"max abs err {f64_err:.3e}, max|ref| {ref_max:.3e} (limit "
        f"{K1_F64_REL:g} of max|ref|)")
    if not f64_err <= K1_F64_REL * ref_max:
        raise AssertionError(f"spmm_bsr {shape_name}: HIGHEST misses the "
                             f"float32 bound against float64")
    del out, ref, head
    ms, plain_ms, four = time_pair(lambda: k1.spmm_bsr(bsr, b),
                                   lambda: k1.spmm_bsr_reference(bsr, b),
                                   iters)
    per_block = 2 * bsr.bm * bsr.bk * b.shape[1]
    log(f"  spmm_bsr {shape_name}: {bsr.nblocks} blocks, {bsr.n_live} live, "
        f"{bsr.blocks.numel() * 4 / 2**20:.1f} MiB; kernel {four[1]:.4f} / "
        f"{four[2]:.4f} ms, plain {four[0]:.4f} / {four[3]:.4f} ms (median "
        f"of {iters}, plain-kernel-kernel-plain); kernel "
        f"{per_block * bsr.n_live / ms / 1e9:.2f} TFLOP/s over live blocks, "
        f"{per_block * bsr.nblocks / ms / 1e9:.2f} over all; plain "
        f"{per_block * bsr.nblocks / plain_ms / 1e9:.2f} over all")
    return err, ms, plain_ms


def live_blocks_csr(bsr) -> torch.Tensor:
    """The live blocks of ``bsr`` as one ``torch.sparse_csr_tensor`` of
    the padded shape on the card (every element of a live block stored),
    for ``torch.sparse.mm``: the BSR layout PyTorch refuses for non-square
    blocks, in the layout it takes."""
    live = bsr.live_idx.long()
    bm, bk = bsr.bm, bsr.bk
    dev = bsr.blocks.device
    rows = (bsr.block_rows.long()[live][:, None, None] * bm
            + torch.arange(bm, device=dev)[None, :, None]).expand(-1, -1, bk)
    cols = (bsr.block_cols.long()[live][:, None, None] * bk
            + torch.arange(bk, device=dev)[None, None, :]).expand(-1, bm, -1)
    rows, cols = rows.reshape(-1), cols.reshape(-1)
    order = torch.argsort(rows * bsr.padded_cols + cols)
    crow = torch.zeros(bsr.padded_rows + 1, dtype=torch.long, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=bsr.padded_rows),
                            0)
    return torch.sparse_csr_tensor(
        crow, cols[order], bsr.blocks[live].reshape(-1)[order],
        size=(bsr.padded_rows, bsr.padded_cols))


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


def compare(name: str, out: torch.Tensor, ref: torch.Tensor, *,
            rtol: float = RTOL, atol_of_max: float = ATOL_OF_MAX) -> float:
    """Raise unless ``out`` matches ``ref`` within the stated tolerance;
    return the max abs error."""
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite values")
    diff = (out - ref).abs()
    ref_max = float(ref.abs().max()) if ref.numel() else 0.0
    bound = rtol * ref.abs() + atol_of_max * ref_max
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = max_abs / ref_max if ref_max else 0.0
    if not bool((diff <= bound).all()):
        raise AssertionError(f"{name}: max abs err {max_abs:.3e} "
                             f"(rel {max_rel:.3e}) exceeds tolerance")
    log(f"  {name}: max abs err {max_abs:.3e}, rel to max|ref| "
        f"{max_rel:.3e}, ok")
    return max_abs


# The card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(bytes_moved: float, flops: float) -> dict:
    """The least milliseconds the card could take for this work and which
    of the two limits it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def library_time(name: str, make, ref: torch.Tensor, iters: int):
    """Milliseconds of one PyTorch call that computes the same function
    (``make()`` returns the call), or None with the reason logged where
    PyTorch refuses the operand. A yardstick only: nothing in the port
    calls it. Its result is held to ``ref`` like a kernel's."""
    from basic_sparse_matrix_tpu_torch.runtime.timing import cuda_time_ms

    try:
        call = make()
        out = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, ValueError) as err:
        log(f"  {name}: PyTorch refuses this operand: "
            f"{str(err).splitlines()[0][:200]}")
        return None
    compare(f"{name} vs the kernel's output", out[: ref.shape[0]], ref)
    del out
    ms = cuda_time_ms(call, warmup=1, iters=iters)
    log(f"  {name}: {ms:.4f} ms (median of {iters})")
    return ms


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
    from basic_sparse_matrix_tpu_torch.ops.pallas import entry_fma
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular

    return {"spmm_bsr": spmm_kernel, "spmm_stream": stream_kernel,
            "runs_read": runs_read, "addback_resident": addback_resident,
            "panel_addback": panel_addback, "entry_fma": entry_fma,
            "trsv_level": sparse_triangular}


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
    from basic_sparse_matrix_tpu_torch.runtime import symbolic

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)    # the default device
    if a.device.type != "cuda":
        raise AssertionError(f"CSR.from_coo_arrays built on {a.device}, not "
                             f"on the card")
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
            + " ms host clock (synchronised; the first captures the "
            "solve graphs, the others replay them)")
    log(f"  peak device memory {peak / 2**30:.3f} GiB")
    levels = rect_levels(sched)
    log(f"  launches {launches}; levels routed to the rect entry {levels}")
    if launches["runs_read"] < sched.n_groups:
        raise AssertionError("K3 did not read for every group")
    check_rects("the solver's factorization", launches, levels)

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


def rect_levels(sched) -> int:
    """The number of levels the schedule routes to the add-back
    (``"rects"``) under ``supernodal_scatter="auto"``."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    return sum(int(sched.tabs[gi][0].shape[0]) for gi in range(sched.n_groups)
               if sn._group_delta(sched, gi, "auto") == "rects")


def addback_groups(sched) -> tuple:
    """(g4, g5): the largest group (by level-0 target slots) that the JAX
    package sends to K4 and the first it sends to K5; both take the rect
    entry here."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    tcp = sn._TABLE_INDEX["tgt_cp"]
    routed = [g for g in range(sched.n_groups)
              if sn._group_delta(sched, g, "auto") == "rects"]
    g4 = max((g for g in routed if sched.use_vmem[g]),
             key=lambda g: sched.tabs[g][tcp][0].numel())
    return g4, next(g for g in routed if not sched.use_vmem[g])


def check_rects(what: str, launches: dict, levels: int) -> None:
    """Raises unless the rect entry (every launch through
    ``addback_resident.addback_rects``) launched once a routed level
    (:func:`rect_levels`) and the K5 module's span wrapper not at all."""
    if (launches["addback_resident"], launches["panel_addback"]) != (
            levels, 0) or not levels:
        raise AssertionError(f"{what}: add-back launches "
                             f"{launches['addback_resident']} through "
                             f"addback_rects and {launches['panel_addback']} "
                             f"through panel_addback, expected {levels} and 0")


def padded_factor(solver) -> torch.Tensor:
    """The factor's flat CSC values with the zero padding
    factorize_supernodal gives them under the default configuration (the
    CSR of L holds them by row; the schedule's pattern gives the order)."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    sched = solver.sched
    pad = 1 + sn._win_pad(sched)
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


def time_turns(plain, kerns: dict, iters: int) -> dict:
    """CUDA-event times in turns plain, kernels, kernels reversed, plain:
    for each name the better median of its two turns with that turn's min
    and max, ``{"name": {"ms", "min_ms", "max_ms", "turns"}}``."""
    from basic_sparse_matrix_tpu_torch.probes.stream_slice_probe import (
        event_times_ms)

    order = ["plain", *kerns, *reversed(list(kerns)), "plain"]
    fns = {"plain": plain, **kerns}
    seen = {}
    for name in order:
        seen.setdefault(name, []).append(
            event_times_ms(fns[name], iters, warmup=1))
    return {name: {**min(turns, key=lambda t: t["ms"]),
                   "turns": [t["ms"] for t in turns]}
            for name, turns in seen.items()}


def stream_kernels_vs_plain(plan, a_st, b_st) -> tuple:
    """Phase 3 for K2: both kernels of ``spmm_stream`` against the plain
    version at the main shape, timed in turns; the L2 gather rate; K6 on the
    same entries; a call
    on operands the dispatch sends to the tile kernel. Returns the
    ``kernels`` entry of the kernel the main path dispatches to and its ns
    per entry."""
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
    from basic_sparse_matrix_tpu_torch.probes import stream_slice_probe as sp

    dev = b_st.device
    k, n = (int(x) for x in b_st.shape)
    _, longest = k2.cell_row_pointers(plan)
    picked, w = k2.pick_stream_kernel(plan.rows, k, n, plan.n_kt,
                                      longest)
    log(f"  spmm_stream dispatch at {plan.rows}x{k} x {n}: longest row "
        f"{longest} slots, B {k * n * 4 / 2**20:.0f} MiB against an L2 budget "
        f"of {k2.L2_SLICE_BUDGET_BYTES / 2**20:.0f} MiB -> {picked!r}, w {w}")
    if picked != "sliced":
        raise AssertionError("the main shape did not dispatch to the sliced "
                             "kernel")
    ref = k2.spmm_stream_reference(plan, b_st)
    runs = {"tile": lambda: k2.spmm_stream_tile(plan, b_st),
            "sliced": lambda: k2.spmm_stream_sliced(plan, b_st)}
    outs, errs = {}, {}
    for name, run in runs.items():
        outs[name] = run()
        torch.cuda.synchronize()
        errs[name] = compare(f"spmm_stream {name} kernel vs plain",
                             outs[name], ref)
    same = bool(torch.equal(outs["sliced"], runs["sliced"]()))
    log(f"  sliced kernel bitwise equal across two calls: {same}; bitwise "
        f"equal to the tile kernel: "
        f"{bool(torch.equal(outs['sliced'], outs['tile']))}")
    if not same:
        raise AssertionError("the sliced kernel is not repeatable")
    before = dict(k2.LAUNCHES_BY_KERNEL)
    out_k = k2.spmm_stream(plan, b_st)
    if k2.LAUNCHES_BY_KERNEL["sliced"] != before["sliced"] + 1 \
            or not torch.equal(out_k, outs["sliced"]):
        raise AssertionError("spmm_stream did not launch the sliced kernel")
    del ref, outs
    times = time_turns(lambda: k2.spmm_stream_reference(plan, b_st), runs, 5)
    for name, t in times.items():
        log(f"  spmm_stream {name}: {t['ms']:.4f} ms (min {t['min_ms']:.4f}, "
            f"max {t['max_ms']:.4f}; medians of its two turns "
            + " / ".join(f"{x:.4f}" for x in t["turns"])
            + "; median of 5, plain-tile-sliced-sliced-tile-plain)")

    def csr_library():
        t = torch.sparse_csr_tensor(a_st.indptr, a_st.indices, a_st.values,
                                    size=a_st.shape)
        return lambda: torch.sparse.mm(t, b_st)
    lib_ms = library_time("torch.sparse.mm(sparse_csr_tensor 1M x 1M, B)",
                          csr_library, out_k, 5)
    slots = plan.ii.numel()
    ms = times[picked]["ms"]
    # the slot arrays and B read once, C written once; one multiply-add per
    # stored entry and column
    entry = {"name": "spmm_stream", "route": "cuda",
             "source": "basic_sparse_matrix_tpu_torch/csrc/spmm_stream.cu",
             "replaces": "basic_sparse_matrix_tpu/ops/pallas/"
                         "stream_kernel.py:178",
             "launches": 0, "max_abs_err": errs[picked], "ms": ms,
             "plain_ms": times["plain"]["ms"],
             **bound(12 * slots + 4 * (b_st.numel() + plan.rows * n),
                     2.0 * plan.nnz * n),
             "library_ms": lib_ms,
             "kernel": f"{picked} (w = {w}, B read as it lies)",
             "min_ms": times[picked]["min_ms"],
             "max_ms": times[picked]["max_ms"],
             "tile_kernel_ms": times["tile"]["ms"]}
    ns_per_entry = ms * 1e6 / plan.nnz
    k6_on_stream_entries(plan, b_st, out_k, ns_per_entry)
    del out_k
    gather_bytes = plan.nnz * (8 + 4 * n) + plan.rows * n * 4
    log(f"  spmm_stream: {gather_bytes / ms / 1e6:.1f} GB/s by the gather "
        f"byte model nnz*(8+4n) + rows*n*4 (tile kernel "
        f"{gather_bytes / times['tile']['ms'] / 1e6:.1f})")

    rates = {nbytes: sp.l2_gather_gbps(nbytes, dev)
             for nbytes in sp.GATHER_ARRAY_BYTES}
    log("  gather of 32-byte pieces at hashed addresses, GB/s by array size: "
        + ", ".join(f"{nb >> 20} MiB {r:.0f}" for nb, r in rates.items()))
    l2_rate = rates[32 << 20]
    log(f"  floor of gathering this run's {plan.nnz} x {n * 4}-byte rows of B "
        f"from L2 at the 32 MiB rate: "
        f"{plan.nnz * n * 4 / l2_rate / 1e6:.2f} ms")

    # operands the dispatch sends to the tile kernel: a B that fits the L2
    # budget, and a plan with several k tiles
    rng = np.random.default_rng(SEED + 20)
    rows_s = 20_000
    ri = np.repeat(np.arange(rows_s), 16)
    ci = rng.integers(0, rows_s, ri.size)
    vi = rng.standard_normal(ri.size).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    for label, tile_k, n_s in (("B fits the L2 budget", rows_s, 128),
                               ("8 k tiles", 2500, 512)):
        small = k2.build_stream_plan(ri, ci, vi, rows_s, rows_s,
                                     tile_m=k2.pick_tile_m(rows_s, n_s),
                                     tile_k=tile_k, device=dev)
        b_s = torch.randn((rows_s, n_s), generator=gen, device=dev)
        before = dict(k2.LAUNCHES_BY_KERNEL)
        out = k2.spmm_stream(small, b_s)
        torch.cuda.synchronize()
        if (k2.LAUNCHES_BY_KERNEL["tile"], k2.LAUNCHES_BY_KERNEL["sliced"]) \
                != (before["tile"] + 1, before["sliced"]):
            raise AssertionError(f"{label}: not the tile kernel")
        compare(f"spmm_stream tile kernel by dispatch ({label}: "
                f"{rows_s}x{rows_s}, 16 a row, x {n_s}) vs plain", out,
                k2.spmm_stream_reference(small, b_s))
    return entry, ns_per_entry


def solver_kernels_vs_plain(solver, gen) -> list:
    """Phase 7: K3 and both entries of the add-back kernel (K4, K5) against
    their plain versions at the main path's shapes."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3
    from basic_sparse_matrix_tpu_torch.probes.addback_probe import (
        index_add_tail, seeded_rects)

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
    n_live = int((stf >= 0).sum())

    def runs_library():
        # lvals with l_pad zeros after it, dead and past-the-end starts
        # mapped into that tail (built outside the timed call): then one
        # gather of overlapping windows computes K3's function
        tail = torch.cat([lvals, lvals.new_zeros(lp)])
        starts = torch.where(stf >= 0, stf.long(),
                             lvals.numel()).clamp(max=lvals.numel())
        windows = tail.unfold(0, lp, 1)
        return lambda: windows[starts]
    lib_ms = library_time("lvals.unfold(0, l_pad, 1)[starts] (one gather, "
                          "positions implicit; the zero tail untimed)",
                          runs_library, got, 20)
    # stf read, the live runs read (at most all of lvals), the output
    # written; no arithmetic
    out.append({"name": "runs_read",
                "source": "basic_sparse_matrix_tpu_torch/csrc/runs_read.cu",
                "replaces": "basic_sparse_matrix_tpu/ops/pallas/"
                            "runs_read.py:98",
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                **bound(4 * (stf.numel() + min(n_live * lp, lvals.numel())
                             + stf.numel() * lp), 0.0),
                "library_ms": lib_ms})

    # K4 and K5: the add-back operands of one group each, level 0.
    def targets(gi):
        return tuple(sched.tabs[gi][tab[name]][0].long()
                     for name in ("tgt_cp", "tgt_nrows", "tgt_w"))
    g4, g5 = addback_groups(sched)
    rect4 = targets(g4)
    tcp, tnr, twd = rect4
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

    rect5 = targets(g5)
    tcp, tnr, twd = rect5
    st, wt = tcp.shape
    col_len = sn._colq(sched.delta_rmax[g5]) + 1024
    st_q, wt_q = sn._pow2(st), sn._pow2(wt)
    psh = live_rows(tnr, twd, tcp, col_len, (st_q, wt_q, col_len), gen)
    tcp_q = torch.nn.functional.pad(tcp, (0, wt_q - wt, 0, st_q - st))
    twd_q = torch.nn.functional.pad(twd, (0, st_q - st))
    k5_args = (psh, tcp_q.to(torch.int32), twd_q.to(torch.int32))
    k5_desc = (f"group {g5}, psh {tuple(psh.shape)} (St {st}, Wt {wt}), "
               f"{int(twd.sum())} live columns")

    # The span entry (what addback_resident / panel_addback launch when
    # called by name; the main path launches it no time on the card).
    spans = {}
    for name, kern, plain, args, desc in (
            ("addback_resident", k4.addback_resident,
             k4.addback_resident_reference, k4_args, k4_desc),
            ("panel_addback", k5.panel_addback,
             k5.panel_addback_reference, k5_args, k5_desc)):
        rows = args[0]
        nz = int((rows != 0).sum())
        timing = addback_vs_plain(
            f"{name} (span entry; {desc}; {nz} nonzero row elements, rows "
            f"{rows.numel() * 4 / 2**20:.1f} MiB)", lvals,
            lambda lv: kern(lv, *args), lambda lv: plain(lv, *args))
        ref = plain(lvals.clone(), *args)
        work = lvals.clone()
        lib_ms = library_time(
            f"index_add_ with its positions built ({name}'s operands)",
            lambda: lambda: plain(work, *args), ref, 20)
        # What the function needs: the tables (every slot's start, K5's
        # twd), the nonzero row elements (a dead slot's row and a run's
        # trailing zeros change nothing and need not be read), the touched
        # factor values read and written (at most all of lvals); one add per
        # nonzero row element.
        tables = sum(t.numel() for t in args[1:])
        touched = min(nz, lvals.numel())
        spans[name] = {
            "entry": "bsm_addback", "route": "cuda", "launches": 0, **timing,
            **bound(4 * (tables + nz + 2 * touched), float(nz)),
            "bound_ms_reading_all_rows": bound(
                4 * (tables + rows.numel() + 2 * touched),
                float(nz))["bound_ms"],
            "library_ms": lib_ms, "nonzero_row_elements": nz}
        del ref, work
    del k4_args, k5_args, psh, psh2

    # The rect entry, what the main path launches on the card through
    # addback_rects on every routed level: the same two groups' target
    # tables with seeded rects. Each row's times, bound and launches are the
    # rect entry's; the span entry's numbers ride along under "span_entry".
    launch = k4.addback_rects
    for name, label, gi, (tcp, tnr, twd), replaces in (
            ("addback_resident", "K4", g4, rect4,
             "basic_sparse_matrix_tpu/ops/pallas/addback_resident.py:106"),
            ("panel_addback", "K5", g5, rect5,
             "basic_sparse_matrix_tpu/ops/pallas/panel_addback.py:135")):
        p = seeded_rects(tcp, tnr, twd, sched.delta_rmax[gi], gen)
        live = int((p != 0).sum())
        desc = (f"{launch.__name__} (rect entry; {label} group {gi}, p "
                f"{tuple(p.shape)} = {p.numel() * 4 / 2**20:.1f} MiB, {live} "
                f"live elements)")
        timing = addback_vs_plain(
            desc, lvals, lambda lv: launch(lv, p, tcp, tnr, twd),
            lambda lv: k4.addback_rects_reference(lv, p, tcp, tnr, twd))
        ref = k4.addback_rects_reference(lvals.clone(), p, tcp, tnr, twd)
        work = lvals.clone()
        lib_ms = library_time(
            f"index_add_ with its positions built ({label} group {gi})",
            lambda: lambda: index_add_tail(work, p, tcp, tnr, twd, scratch),
            ref[:scratch], 20)
        # the live elements of p, tcp, tnr and twd read, the touched factor
        # values read and written, one add per live element
        touched = min(live, lvals.numel())
        tables = tcp.numel() + 2 * tnr.numel()
        out.append({"name": name,
                    "source": "basic_sparse_matrix_tpu_torch/csrc/addback.cu",
                    "replaces": replaces, "entry": "bsm_addback_rects",
                    "wrapper": launch.__name__, **timing,
                    **bound(4 * (live + tables + 2 * touched), float(live)),
                    "bound_ms_reading_all_of_p": bound(
                        4 * (p.numel() + tables + 2 * touched),
                        float(live))["bound_ms"],
                    "library_ms": lib_ms, "group": gi,
                    "rect_shape": list(p.shape), "live_elements": live,
                    "span_entry": spans[name]})
        del p, ref, work
    return out


# |kernel - plain| <= ADDBACK_TOL * max(1, max|ref|) for both add-back
# entries: the same float32 adds, in the order the atomics land.
ADDBACK_TOL = 1e-5


def addback_vs_plain(desc: str, lvals, kern, plain) -> dict:
    """Hold an add-back entry (``kern(lv)``, in place) to its plain version
    on a copy of ``lvals``, then time both in turns plain-kernel-kernel-plain:
    event pairs at the host's pace (min and max of the kernel's two turns)
    and, for the kernel, with the launches queued behind a spin kernel
    (device only)."""
    from basic_sparse_matrix_tpu_torch.probes.entry_fma_probe import (
        device_time_ms)

    got = kern(lvals.clone())
    torch.cuda.synchronize()
    ref = plain(lvals.clone())
    err = float((got - ref).abs().max())
    limit = ADDBACK_TOL * max(1.0, float(ref.abs().max()))
    log(f"  {desc}: max abs err {err:.3e} (limit {limit:.3e})")
    if not (bool(torch.isfinite(got).all()) and err <= limit):
        raise AssertionError(f"{desc}: kernel differs from its plain version")
    del got, ref
    work = lvals.clone()
    ms, plain_ms, four = time_pair(lambda: kern(work), lambda: plain(work),
                                   20)
    dev = [device_time_ms(lambda: kern(work), 50) for _ in range(2)]
    log(f"    a call at the host's pace: kernel {four[1]:.4f} / {four[2]:.4f} "
        f"ms, plain {four[0]:.4f} / {four[3]:.4f} ms (medians of 20, "
        f"plain-kernel-kernel-plain); device only: kernel {dev[0]:.4f} / "
        f"{dev[1]:.4f} ms (medians of 50)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "min_ms": min(four[1:3]), "max_ms": max(four[1:3]),
            "device_ms": min(dev)}


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
            want = {"runs_read": True, "addback_resident": any(
                sn._group_delta(sched, gi, scatter) == "rects"
                for gi in range(sched.n_groups)), "panel_addback": False}
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


# ---- the rest of models/ (phases 9-13) -----------------------------------
TREE_N = 1_000_000
BANDED_NB = 840      # block_size_for(RCM bandwidth 833, n = 35,937)
TSQR_SHAPE = (1 << 20, 64)
LAMBDA_MAX = 6.0 * (1.0 + np.cos(np.pi / (SOLVER_K + 1)))
LAMBDA_MIN = 6.0 * (1.0 - np.cos(np.pi / (SOLVER_K + 1)))
PCG_RES_MAX = 1e-5
CHEBY_RES_MAX = 1e-4
# A k-step Ritz value lies inside the spectrum and converges toward λ_max at
# a rate set by the start vector and the top of the spectrum (eigenvalues
# 0.2% apart here): at k = 32, seeded start vectors land 1.0e-3 to 4.5e-3
# below it (three on the CPU, the card's seed 0), so that bound is a sanity
# check of convergence. What holds the card's arithmetic is the comparison
# of its Ritz values with the CPU's from one start vector: float32 rounding
# moves them by up to 5.5e-5 of their size on the CPU (the JAX package
# against the port).
RITZ_MAX_REL = 1e-2
RITZ_MIN_SLACK = 1e-4
RITZ_RTOL = 1e-4
RITZ_ATOL_OF_MAX = 1e-6
TSQR_RES_MAX = 1e-5
TSQR_ORTH_MAX = 1e-4


def use_config(**fields) -> None:
    """Every config field at its default, then ``fields``."""
    from basic_sparse_matrix_tpu_torch.utils import config

    config.set_config(config.Config(**fields))


def tree_laplacian(n: int, seed: int):
    """The Laplacian of a random recursive tree plus I (node i joins a
    uniformly random earlier node) as COO arrays."""
    rng = np.random.default_rng(seed)
    par = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    ch = np.arange(1, n)
    deg = np.bincount(par, minlength=n) + np.bincount(ch, minlength=n)
    rows = np.concatenate([np.arange(n), ch, par])
    cols = np.concatenate([np.arange(n), par, ch])
    vals = np.concatenate([deg + 1.0, -np.ones(2 * (n - 1))])
    return n, rows, cols, vals.astype(np.float32)


def matvec64(a, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in float64 on ``a``'s device (x of shape (n,) or (n, k))."""
    x = x.double()
    rows = a.row_ids().long()
    vals = a.values.double().reshape((-1,) + (1,) * (x.ndim - 1))
    out = torch.zeros((a.rows,) + tuple(x.shape[1:]), dtype=torch.float64,
                      device=x.device)
    return out.index_add_(0, rows, vals * x.index_select(0, a.indices.long()))


def seeded_system(a, seed: int):
    """x_true (n, 8) normal in float64 and b = A·x_true in float32, on the
    card."""
    gen = torch.Generator(device=a.device).manual_seed(seed)
    x_true = torch.randn((a.rows, 8), generator=gen, dtype=torch.float64,
                         device=a.device)
    return x_true, matvec64(a, x_true).float()


def check_solution(name: str, a, x, x_true, b) -> None:
    """Normwise backward and forward errors in float64 on the card, per
    column, against phase 6's limits."""
    x = x.reshape(a.rows, -1).double()
    x_true = x_true[:, : x.shape[1]]
    b = b.reshape(a.rows, -1)[:, : x.shape[1]].double()
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: non-finite solution")
    a_inf = float(torch.zeros(a.rows, dtype=torch.float64, device=x.device)
                  .index_add_(0, a.row_ids().long(), a.values.double().abs())
                  .max())
    res = (b - matvec64(a, x)).abs().amax(0)
    bwd = float((res / (a_inf * x.abs().amax(0) + b.abs().amax(0))).max())
    fwd = float(((x - x_true).abs().amax(0) / x_true.abs().amax(0)).max())
    log(f"  {name}: backward error {bwd:.3e} (limit {BACKWARD_ERR_MAX:g}), "
        f"forward error {fwd:.3e} (limit {FORWARD_ERR_MAX:g})")
    if not (bwd <= BACKWARD_ERR_MAX and fwd <= FORWARD_ERR_MAX):
        raise AssertionError(f"{name}: errors over the limits")


def timed(fn):
    """(result, synchronised host-clock seconds) of ``fn()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fresh_peak() -> int:
    """Free what earlier phases left, reset the peak counter; returns the
    bytes still allocated (the phase's baseline)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def log_peak(name: str, base: int) -> None:
    peak = torch.cuda.max_memory_allocated()
    log(f"  {name}: peak device memory {peak / 2**30:.3f} GiB, "
        f"{(peak - base) / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB held before the set-up")


def log_timings(timings: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())


def solve_and_check(solver, a, x_true, b8, label: str) -> None:
    """Solves with 1 and 8 right-hand sides, three of each timed, the last
    of each checked."""
    for name, b in (("1 rhs", b8[:, 0].contiguous()), ("8 rhs", b8)):
        ms = []
        for _ in range(3):
            x, sec = timed(lambda: solver.solve(b))
            ms.append(sec * 1e3)
        check_solution(f"{label} solve {name}", a, x, x_true, b)
        log(f"  {label} solve {name}: " + " / ".join(
            f"{t:.2f}" for t in ms) + " ms host clock (synchronised; "
            "where the tier has level loops the first captures their "
            "graphs)")


def serving_path(dev) -> None:
    """Phase 9: SparseOperator at the default config on the 33³
    Laplacian."""
    from basic_sparse_matrix_tpu_torch import CSR, SparseOperator

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    x_true, b8 = seeded_system(a, SEED + 3)
    b1 = b8[:, 0].contiguous()
    use_config()
    op = SparseOperator(a)
    base = fresh_peak()
    zero_launches()
    x1, first = timed(lambda: op.solve(b1))
    x1b, second = timed(lambda: op.solve(b1))
    x8, eight = timed(lambda: op.solve(b8))
    launches = read_launches()
    solver = op._direct
    log(f"serving path (SparseOperator, default config): n {n}, kind "
        f"{solver.kind}, set-up {log_timings(solver.timings)}")
    log(f"  first solve (with set-up) {first:.3f} s, second solve (cached "
        f"factor) {second * 1e3:.2f} ms, 8 rhs {eight * 1e3:.2f} ms host "
        f"clock; launches {launches}")
    log_peak("serving", base)
    if solver.kind != "supernodal":
        raise AssertionError(f"default tier {solver.kind!r}, expected "
                             f"supernodal")
    if not (launches["runs_read"] and launches["addback_resident"]) \
            or launches["panel_addback"]:
        raise AssertionError("the serving solve did not launch K3 and the "
                             "rect entry alone")
    check_solution("op.solve 1 rhs (first)", a, x1, x_true, b8)
    check_solution("op.solve 1 rhs (cached)", a, x1b, x_true, b8)
    check_solution("op.solve 8 rhs", a, x8, x_true, b8)
    before = read_launches()
    out = op.matmul(b8)
    after = read_launches()
    compare(f"op.matmul, 8 columns, vs plain gather/segment (launches "
            f"K1 {after['spmm_bsr'] - before['spmm_bsr']}, K2 "
            f"{after['spmm_stream'] - before['spmm_stream']})", out,
            plain_spmm(a, b8))


def direct_round_trip(solver, a, x_true, b8, kind: str) -> None:
    """save_direct → load_direct → solve through a temporary directory;
    the loaded solver meets the same error limits and agrees with the one
    it was saved from."""
    from basic_sparse_matrix_tpu_torch.runtime import checkpoint as ck

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "direct.npz")
        _, saved = timed(lambda: ck.save_direct(path, solver))
        loaded, took = timed(lambda: ck.load_direct(path, device=a.device))
        size = os.path.getsize(path)
    x = loaded.solve(b8)
    log(f"  {kind} save_direct {size / 2**20:.1f} MiB in {saved:.2f} s, "
        f"load_direct (factor rebuilt where the checkpoint holds operands) "
        f"{took:.2f} s, kind {loaded.kind}")
    if loaded.kind != kind:
        raise AssertionError(f"loaded kind {loaded.kind!r}, saved {kind!r}")
    check_solution(f"{kind} loaded solver, 8 rhs", a, x, x_true, b8)
    compare(f"{kind} loaded solver vs the saved one", x, solver.solve(b8))


def banded_tiers(dev) -> None:
    """Phase 10: the BCR and scan tiers on the 33³ Laplacian under RCM."""
    from basic_sparse_matrix_tpu_torch import CSR, prepare_direct

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    x_true, b8 = seeded_system(a, SEED + 4)
    for backend, kind in (("bcr", "banded-bcr"), ("scan", "banded")):
        use_config(ordering="rcm", banded_solver=backend)
        base = fresh_peak()
        solver, setup = timed(lambda: prepare_direct(a))
        nb = solver._banded.nb
        log(f"banded tier, banded_solver={backend!r}: kind {solver.kind}, "
            f"nb {nb}, {-(-n // nb)} block rows, set-up {setup:.3f} s "
            f"({log_timings(solver.timings)})")
        if solver.kind != kind or nb != BANDED_NB:
            raise AssertionError(f"tier {solver.kind!r} nb {nb}, expected "
                                 f"{kind!r} with nb {BANDED_NB}")
        solve_and_check(solver, a, x_true, b8, kind)
        log_peak(kind, base)
        direct_round_trip(solver, a, x_true, b8, kind)
        del solver
    use_config()


def scatter_tier(dev):
    """Phase 11: the scatter-list tier on a 10⁶-node tree Laplacian;
    returns the solver and the matrix (phase 21(b) reuses them)."""
    from basic_sparse_matrix_tpu_torch import CSR, prepare_direct

    (n, r, c, v), build = timed(lambda: tree_laplacian(TREE_N, SEED + 5))
    a, upload = timed(lambda: CSR.from_coo_arrays((n, n), r, c, v,
                                                  device=dev))
    x_true, b8 = seeded_system(a, SEED + 6)
    use_config(ordering="rcm")
    base = fresh_peak()
    solver, setup = timed(lambda: prepare_direct(a))
    s = solver.sched
    log(f"scatter-list tier: tree Laplacian + I, n {n} (arrays {build:.2f} "
        f"s, CSR {upload:.2f} s), kind {solver.kind}, set-up {setup:.3f} s "
        f"({log_timings(solver.timings)})")
    if solver.kind != "scatter":
        raise AssertionError(f"tier {solver.kind!r}, expected scatter")
    per_level = np.diff(s.upd_ptr)
    jax_bytes = 4 * (3 * s.n_levels * max(int(per_level.max()), 1)
                     + s.n_levels * int(np.diff(s.col_ptr).max())
                     * int(np.diff(s.l_col_ptr).max()))
    log(f"  schedule: nnz_l {s.nnz_l}, {s.n_levels} levels, {s.n_triples} "
        f"triples, ragged tables {s.nbytes / 2**20:.1f} MiB; the JAX "
        f"package's padded (levels × max) update and column tables would "
        f"take {jax_bytes / 2**20:.1f} MiB; solve levels fwd "
        f"{solver._fwd.n_levels}, bwd {solver._bwd.n_levels}")
    solve_and_check(solver, a, x_true, b8, "scatter")
    log_peak("scatter", base)
    use_config()
    return solver, a


def iterative_path(dev) -> None:
    """Phase 12: IC(0)-PCG, Lanczos and Chebyshev on the 33³ Laplacian."""
    from basic_sparse_matrix_tpu_torch import CSR, SparseOperator
    from basic_sparse_matrix_tpu_torch.models import chebyshev_solve
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models.lanczos import (
        LanczosSetup, _ritz_values)

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    b = torch.randn(n, generator=gen, device=dev)
    use_config()
    log("iterative and spectral path (33³ Laplacian, natural order):")
    s, t_an = timed(lambda: sc.analyze(a, incomplete=True))
    _, t_fa = timed(lambda: sc.factorize(s, a.values))
    log(f"  IC(0): {s.n_levels} levels, {s.n_triples} triples, analyze "
        f"{t_an:.3f} s, factorize {t_fa * 1e3:.1f} ms (synchronised)")
    op = SparseOperator(a)
    (x, it, res), first = timed(lambda: op.solve_cg(b, tol=1e-6))
    (x, it, res), again = timed(lambda: op.solve_cg(b, tol=1e-6))
    true_res = float(torch.linalg.norm(b.double() - matvec64(a, x))
                     / torch.linalg.norm(b.double()))
    log(f"  solve_cg: first call (IC(0) set-up and graph captures "
        f"included) {first:.3f} s, again (replays) {again * 1e3:.1f} ms "
        f"for {it} iterations = "
        f"{again * 1e3 / max(it, 1):.2f} ms per iteration; reported "
        f"residual {res:.3e}, float64 residual {true_res:.3e} (limit "
        f"{PCG_RES_MAX:g})")
    if not true_res <= PCG_RES_MAX:
        raise AssertionError("solve_cg: residual over the limit")
    ritz, t_lz = timed(lambda: op.eigen_values(32))
    ritz = ritz.double().cpu().numpy()
    rel_max = (LAMBDA_MAX - ritz[-1]) / LAMBDA_MAX
    cond = op.condition_estimate(32)
    log(f"  eigen_values(32) {t_lz * 1e3:.1f} ms: Ritz max {ritz[-1]:.6f} "
        f"(analytic {LAMBDA_MAX:.6f}, {rel_max:.3e} below, limit "
        f"{RITZ_MAX_REL:g}), Ritz min {ritz[0]:.6f} (analytic "
        f"{LAMBDA_MIN:.6f}); condition_estimate {cond:.2f} (analytic "
        f"{LAMBDA_MAX / LAMBDA_MIN:.2f})")
    if not (-1e-5 <= rel_max <= RITZ_MAX_REL
            and ritz[0] >= LAMBDA_MIN - RITZ_MIN_SLACK):
        raise AssertionError("eigen_values(32): Ritz values off the "
                             "spectrum's ends")
    v0 = np.random.default_rng(SEED + 9).standard_normal(n).astype(
        np.float32)
    card = _ritz_values(op._lanczos, torch.as_tensor(v0, device=dev), 32)
    cpu_setup = LanczosSetup.build(
        CSR.from_coo_arrays((n, n), r, c, v, device="cpu"))
    cpu = _ritz_values(cpu_setup, torch.as_tensor(v0), 32)
    compare("Lanczos Ritz values (k = 32, one seeded v0), card vs CPU",
            card.cpu(), cpu, rtol=RITZ_RTOL, atol_of_max=RITZ_ATOL_OF_MAX)
    (x, res), t_ch = timed(lambda: chebyshev_solve(
        a, b, iters=200, bounds=(LAMBDA_MIN, LAMBDA_MAX), setup=op._lanczos))
    true_res = float(torch.linalg.norm(b.double() - matvec64(a, x))
                     / torch.linalg.norm(b.double()))
    log(f"  chebyshev_solve, analytic bounds, 200 iterations: "
        f"{t_ch * 1e3:.1f} ms (the first call: graph capture included), "
        f"reported residual {res:.3e}, float64 "
        f"residual {true_res:.3e} (limit {CHEBY_RES_MAX:g})")
    if not true_res <= CHEBY_RES_MAX:
        raise AssertionError("chebyshev_solve: residual over the limit")
    (x, res), t_ch = timed(lambda: op.solve_chebyshev(b, iters=200))
    log(f"  op.solve_chebyshev, Lanczos bounds, 200 iterations: "
        f"{t_ch * 1e3:.1f} ms (a replay: the bounds are operands), "
        f"residual {res:.3e} (not asserted)")


def card_vs_cpu_k14(dev) -> None:
    """Phase 13: the k = 14 tiers and cholesky_auto on the card against the
    CPU with TF32 switched on by the caller; then TSQR at 2^20 × 64."""
    from basic_sparse_matrix_tpu_torch import CSR, cholesky_auto, prepare_direct
    from basic_sparse_matrix_tpu_torch.models import tsqr

    n, r, c, v = laplacian_3d(FORMULATION_K)
    gen = torch.Generator().manual_seed(SEED + 8)
    b = torch.randn((n, 8), generator=gen)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for kind, fields in (
                ("banded-bcr", dict(banded_solver="bcr")),
                ("banded", dict(banded_solver="scan")),
                ("scatter", dict(banded_max_block=0, supernodal_relax=0)),
                ("cholesky_auto", dict())):
            use_config(ordering="natural", **fields)
            out, probe = {}, MatmulTf32Probe()
            for d in ("cpu", dev):
                a = CSR.from_coo_arrays((n, n), r, c, v, device=d)
                with probe if d == dev else contextlib.nullcontext():
                    if kind == "cholesky_auto":
                        out[d] = {"factor": cholesky_auto(a).todense()}
                        continue
                    solver = prepare_direct(a)
                    x = solver.solve(b.to(d))
                if solver.kind != kind:
                    raise AssertionError(f"k={FORMULATION_K}: tier "
                                         f"{solver.kind!r}, expected {kind!r}")
                fac = {"banded-bcr": lambda s: s._banded.fac.l0,
                       "banded": lambda s: s._banded.L,
                       "scatter": lambda s: s._l.values}[kind](solver)
                out[d] = {"solution": x, "factor": fac}
            torch.cuda.synchronize()
            for name, got in out[dev].items():
                compare(f"k={FORMULATION_K} {kind} {name}, card vs cpu "
                        f"({probe.calls} matmul/factor calls on the card, "
                        f"{probe.tf32} with TF32)", got,
                        out["cpu"][name].to(dev))
            if probe.tf32 or (probe.calls == 0 and kind != "scatter"):
                raise AssertionError(f"{kind}: TF32 was on, or no product "
                                     f"was seen")
        use_config()
        a = torch.randn(TSQR_SHAPE, generator=torch.Generator(
            device=dev).manual_seed(SEED + 9), device=dev)
        probe = MatmulTf32Probe()
        with probe:
            q, rr = tsqr(a)
        torch.cuda.synchronize()
        ad, qd = a.double(), q.double()
        res = float(torch.linalg.norm(ad - qd @ rr.double())
                    / torch.linalg.norm(ad))
        orth = float((qd.T @ qd - torch.eye(
            a.shape[1], dtype=torch.float64, device=dev)).abs().max())
        del ad, qd
        log(f"tsqr {TSQR_SHAPE[0]}x{TSQR_SHAPE[1]}: ‖A − QR‖_F/‖A‖_F "
            f"{res:.3e} (limit {TSQR_RES_MAX:g}), max|QᵀQ − I| {orth:.3e} "
            f"(limit {TSQR_ORTH_MAX:g}); {probe.calls} matmul calls, "
            f"{probe.tf32} with TF32")
        if not (res <= TSQR_RES_MAX and orth <= TSQR_ORTH_MAX) or probe.tf32:
            raise AssertionError("tsqr: residual, orthogonality or TF32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        use_config()
    ms, plain_ms, four = time_pair(lambda: tsqr(a),
                                   lambda: torch.linalg.qr(a), 5)
    log(f"  tsqr {four[1]:.3f} / {four[2]:.3f} ms, torch.linalg.qr "
        f"{four[0]:.3f} / {four[3]:.3f} ms on the same operand (median of "
        f"5, qr-tsqr-tsqr-qr)")


# ---- the sparse × sparse path, file round trips and K6 (phases 14-18) -------
SS_N = 1000              # the reference ss_add / ss_mul operand order
SS_ADD_INSERTS = 900_000
SS_MUL_INSERTS = 500_000
PLANNED_N = 100_000
K6_MAX_ABS_ERR = 1e-4


def bench_csr(seed: int, n: int, inserts: int, dev):
    """A reference-bench operand: ``inserts`` random coordinates in n × n,
    values 1..255, duplicates summed."""
    from basic_sparse_matrix_tpu_torch import CSR

    r = np.random.default_rng(seed)
    return CSR.from_coo_arrays(
        (n, n), r.integers(0, n, inserts), r.integers(0, n, inserts),
        (r.integers(0, 2**32, inserts) % 255 + 1).astype(np.float32),
        device=dev)


def dense64(a) -> torch.Tensor:
    """``a`` densified in float64 on its device."""
    out = torch.zeros(a.rows * a.cols, dtype=torch.float64, device=a.device)
    out.index_add_(0, a.row_ids().long() * a.cols + a.indices.long(),
                   a.values.double())
    return out.view(a.rows, a.cols)


def k6_on_stream_entries(plan, b, out_k2, k2_ns: float) -> None:
    """K6 on the streaming kernel's own entries (phase 3): the same
    function as K2 at K2's shape, held to K2's output and timed."""
    from basic_sparse_matrix_tpu_torch.ops.pallas import entry_fma as k6
    from basic_sparse_matrix_tpu_torch.runtime.timing import cuda_time_ms

    if plan.n_kt != 1:
        log("  entry_fma on the stream plan's entries: skipped, the plan "
            "has more than one k tile")
        return
    base = torch.arange(plan.n_rt, device=b.device, dtype=torch.int32) \
        * plan.tile_m
    ii = (plan.ii[:, 0, :] + base[:, None]).reshape(-1).contiguous()
    kk = plan.kk.reshape(-1)
    vv = plan.vv.reshape(-1)
    out = k6.entry_fma(ii, kk, vv, b, plan.rows)
    torch.cuda.synchronize()
    compare("entry_fma on the stream plan's entries vs spmm_stream", out,
            out_k2)
    del out
    ms = cuda_time_ms(lambda: k6.entry_fma(ii, kk, vv, b, plan.rows,
                                           check_range=False),
                      warmup=1, iters=3)
    log(f"  entry_fma on the stream plan's {ii.numel()} slots ({plan.nnz} "
        f"entries), {plan.rows} rows x {b.shape[1]} lanes: {ms:.3f} ms = "
        f"{ms * 1e6 / plan.nnz:.3f} ns per entry; spmm_stream "
        f"{k2_ns:.3f} ns per entry")


def ss_add_path(dev) -> None:
    """Phase 14: a + b, a - b, a * 3 at the reference ss_add size."""
    from basic_sparse_matrix_tpu_torch.ops import elementwise as ew

    a = bench_csr(1000, SS_N, SS_ADD_INSERTS, dev)
    b = bench_csr(2000, SS_N, SS_ADD_INSERTS, dev)
    da, db = dense64(a), dense64(b)
    base = fresh_peak()
    c, first = timed(lambda: a + b)
    c2, cached = timed(lambda: a + b)
    d, sub_cached = timed(lambda: a - b)
    e, scale = timed(lambda: a * 3)
    log(f"ss_add ({SS_N}x{SS_N}, {SS_ADD_INSERTS} inserts each, stored "
        f"{a.stored} and {b.stored}): a + b first call (host plan) "
        f"{first:.3f} s, cached {cached * 1e3:.3f} ms; a - b (same plan) "
        f"{sub_cached * 1e3:.3f} ms; a * 3 {scale * 1e3:.3f} ms; output "
        f"capacity {c.stored}, nonzero {int((c.values != 0).sum())}")
    if len(a._merge_plans) != 1 or c2.indices is not c.indices:
        raise AssertionError("ss_add: the second call built a plan")
    compare("a + b vs dense sum", dense64(c), da + db)
    compare("a - b vs dense difference", dense64(d), da - db)
    compare("a * 3 vs dense", dense64(e), 3 * da)
    # (a + b) stores its padding slots at one coordinate: the plan refuses
    # and the key-space merge takes over
    f, fallback = timed(lambda: c - b)
    if c._merge_plans:
        raise AssertionError("ss_add: a capacity-padded operand was planned")
    compare("(a + b) - b vs a (key-space fallback)", dense64(f), da)
    log(f"  (a + b) - b through the key-space merge: {fallback * 1e3:.3f} "
        f"ms; sum_elements {float(ew.sum_elements(c)):.6g} (dense "
        f"{float((da + db).sum()):.6g}), l2_norm {float(ew.l2_norm(a)):.6g} "
        f"(dense {float(da.square().sum().sqrt()):.6g})")
    log_peak("ss_add", base)


def ss_mul_dense_path(dev) -> None:
    """Phase 15: spgemm on the masked-dense rung at the reference size."""
    from basic_sparse_matrix_tpu_torch import spgemm

    a = bench_csr(3000, SS_N, SS_MUL_INSERTS, dev)
    b = bench_csr(4000, SS_N, SS_MUL_INSERTS, dev)
    c, first = timed(lambda: spgemm(a, b))
    c, again = timed(lambda: spgemm(a, b))
    log(f"ss_mul masked-dense ({SS_N}x{SS_N}, {SS_MUL_INSERTS} inserts each, "
        f"stored {a.stored} and {b.stored}): spgemm first {first * 1e3:.2f} "
        f"ms, again {again * 1e3:.2f} ms (dense product, then the host "
        f"re-sparsifies); nnz(C) {c.stored}")
    if a._spgemm_plans:
        raise AssertionError("ss_mul 1000²: took the planned path")
    compare("spgemm vs a.todense() @ b.todense() in float64",
            dense64(c), dense64(a) @ dense64(b))


def check_product_pattern(name: str, a, b, c) -> None:
    """nnz(C) and C's whole pattern against a host Gustavson pass: scipy's
    SpGEMM on all-ones operands (no cancellation)."""
    import scipy.sparse as sp

    ia, xa, _ = a.numpy()
    ib, xb, _ = b.numpy()
    ic, xc, _ = c.numpy()
    pc = sp.csr_matrix((np.ones(xa.size), xa, ia), shape=a.shape) \
        @ sp.csr_matrix((np.ones(xb.size), xb, ib), shape=b.shape)
    pc.sort_indices()
    if not (np.array_equal(pc.indptr, ic) and np.array_equal(pc.indices, xc)):
        raise AssertionError(f"{name}: pattern differs from the host "
                             f"Gustavson product")
    log(f"  {name}: nnz(C) {xc.size} and the whole pattern equal the host "
        f"Gustavson product (scipy)")


def sampled_columns(m, cols: np.ndarray) -> torch.Tensor:
    """The dense (rows, len(cols)) slice ``m[:, cols]`` on ``m``'s device."""
    slot = torch.full((m.cols,), -1, dtype=torch.long, device=m.device)
    slot[torch.as_tensor(cols, device=m.device)] = torch.arange(
        len(cols), device=m.device)
    where = slot[m.indices.long()]
    keep = where >= 0
    out = torch.zeros((m.rows, len(cols)), dtype=torch.float32,
                      device=m.device)
    out.index_put_((m.row_ids().long()[keep], where[keep]),
                   m.values[keep].float(), accumulate=True)
    return out


def planned_case(name: str, a, b, entry) -> None:
    """One planned product through ``entry(a, b)``: plan and numeric times,
    sampled columns against the plain SpMM, the pattern against the host."""
    from basic_sparse_matrix_tpu_torch.ops.spgemm import (
        _plan_numeric, _SpgemmPlan)
    from basic_sparse_matrix_tpu_torch.runtime.timing import cuda_time_ms

    base = fresh_peak()
    c, first = timed(lambda: entry(a, b))
    c, again = timed(lambda: entry(a, b))
    if not a._spgemm_plans or len(a._spgemm_plans) != 1:
        raise AssertionError(f"{name}: did not take the planned path once")
    plan = a._spgemm_plans[0][1]
    if not isinstance(plan, _SpgemmPlan):
        raise AssertionError(f"{name}: expected one plan, not row chunks")
    ms = cuda_time_ms(lambda: _plan_numeric(plan, a.values, b.values),
                      warmup=1, iters=5)
    log(f"{name}: stored {a.stored} x {b.stored}, first call (host plan) "
        f"{first:.3f} s, cached call {again * 1e3:.3f} ms, numeric phase "
        f"{ms:.4f} ms (CUDA events, median of 5), expansion "
        f"{plan.expansion}, nnz(C) {plan.nnz_c}")
    log_peak(name, base)
    cols = np.sort(np.random.default_rng(SEED + 10).choice(b.cols, 16, False))
    compare(f"{name}: 16 sampled columns of C vs plain SpMM of A with "
            f"those columns of B", sampled_columns(c, cols),
            plain_spmm(a, sampled_columns(b, cols)))
    check_product_pattern(name, a, b, c)


def ss_mul_planned_path(dev) -> None:
    """Phase 16: spgemm past the dense budget, short and long rows."""
    from basic_sparse_matrix_tpu_torch import CSR, spgemm

    n = PLANNED_N
    planned_case(f"ss_mul planned (n {n}, {SS_MUL_INSERTS} inserts each)",
                 bench_csr(5000, n, SS_MUL_INSERTS, dev),
                 bench_csr(6000, n, SS_MUL_INSERTS, dev), spgemm)
    rng = np.random.default_rng(7000)
    ra, ca = rng.integers(0, n, 200_000), rng.integers(0, n, 200_000)
    va = (rng.integers(0, 2**32, 200_000) % 255 + 1).astype(np.float32)
    rb = np.repeat(np.arange(n), 64)
    cb = rng.integers(0, n, 64 * n)
    vb = (rng.integers(0, 2**32, 64 * n) % 255 + 1).astype(np.float32)
    planned_case(f"ss_mul planned, long rows (n {n}, A 200000 inserts, B 64 "
                 f"a row)",
                 CSR.from_coo_arrays((n, n), ra, ca, va, device=dev),
                 CSR.from_coo_arrays((n, n), rb, cb, vb, device=dev), spgemm)


def matmul_sparse_path(dev) -> None:
    """Phase 17: SparseOperator.matmul_sparse on the 33³ Laplacian, and the
    Matrix Market round trip of that matrix."""
    from basic_sparse_matrix_tpu_torch import CSR, SparseOperator
    from basic_sparse_matrix_tpu_torch.runtime import io as mm

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    op = SparseOperator(a)
    planned_case(f"matmul_sparse (33³ Laplacian, A·A, n {n})", a, a,
                 lambda x, y: op.matmul_sparse(y))
    aa = op.matmul_sparse(a)
    per_row = np.diff(aa.numpy()[0])
    inner = (SOLVER_K // 2 * SOLVER_K + SOLVER_K // 2) * SOLVER_K \
        + SOLVER_K // 2
    if per_row[inner] != 25 or per_row.max() != 25:
        raise AssertionError(f"A·A: {per_row[inner]} entries in an inner "
                             f"row, most {per_row.max()}, expected 25")
    cols = np.arange(inner - 4, inner + 4)
    compare("matmul_sparse(A)[:, slice] vs op.matmul(A[:, slice] dense)",
            sampled_columns(aa, cols), op.matmul(sampled_columns(a, cols)))
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("laplacian.mtx", "laplacian.mtx.gz"):
            path = os.path.join(tmp, name)
            _, wrote = timed(lambda: mm.write_matrix_market(path, a, "33^3"))
            back, read = timed(lambda: mm.read_matrix_market(path, device=dev))
            size = os.path.getsize(path)
            same = all(torch.equal(x, y) for x, y in (
                (back.indptr, a.indptr), (back.indices, a.indices),
                (back.values, a.values)))
            log(f"  {name}: wrote {size} bytes in {wrote:.2f} s, read in "
                f"{read:.2f} s, entry for entry equal: {same}")
            if not same or back.shape != a.shape:
                raise AssertionError(f"{name}: round trip differs")


def k6_phase(dev, k2_main: float) -> dict:
    """Phase 18: K6 against its plain version at three shapes, its times,
    the library call, and the probe (K6's main path). ``k2_main`` is the
    streaming kernel's ns per entry at its own shape (phase 3)."""
    from basic_sparse_matrix_tpu_torch.ops.pallas import entry_fma as k6
    from basic_sparse_matrix_tpu_torch.probes import entry_fma_probe as probe

    log("entry_fma (K6) vs plain on the card:")
    entries, rows = 8192, 4096
    timing = {}
    for label, lanes, hot in (("default shape", 128, None),
                              ("512 lanes", 512, None),
                              ("one hot row", 128, 17)):
        ii_h, kk_h, vv_h, b_h = probe.make_entries(entries, rows, lanes)
        if hot is not None:
            ii_h[:] = hot
        ii, kk, vv, b = (torch.as_tensor(x, device=dev)
                         for x in (ii_h, kk_h, vv_h, b_h))
        ref = k6.entry_fma_reference(ii, kk, vv, b, rows)
        scale = max(float(ref.abs().max()), 1.0)
        ref64 = probe.oracle(ii_h, kk_h, vv_h, b_h, rows)
        before = k6.LAUNCHES
        out = k6.entry_fma(ii, kk, vv, b, rows)
        torch.cuda.synchronize()
        if k6.LAUNCHES != before + 1:
            raise AssertionError("entry_fma: not launched")
        err = float((out - ref).abs().max())
        err64 = float(np.abs(out.double().cpu().numpy() - ref64).max())
        log(f"  entry_fma, {label} (E {entries}, R {rows}, lanes {lanes}): "
            f"max abs err vs plain {err:.3e}, vs float64 {err64:.3e} (limit "
            f"{K6_MAX_ABS_ERR:g} x {scale:.3g})")
        if not (err < K6_MAX_ABS_ERR * scale
                and err64 < K6_MAX_ABS_ERR * scale):
            raise AssertionError(f"entry_fma {label}: error over the limit")
        ms, plain_ms, four = time_pair(
            lambda: k6.entry_fma(ii, kk, vv, b, rows, check_range=False),
            lambda: k6.entry_fma_reference(ii, kk, vv, b, rows), 50)
        log(f"  entry_fma, {label}: a call at the host's pace, kernel "
            f"{four[1]:.4f} / {four[2]:.4f} ms, plain {four[0]:.4f} / "
            f"{four[3]:.4f} ms (median of 50, plain-kernel-kernel-plain)")
        if hot is None and lanes == 128:
            def coo_library():
                t = torch.sparse_coo_tensor(
                    torch.stack([ii.long(), kk.long()]), vv,
                    (rows, rows)).coalesce()
                return lambda: torch.sparse.mm(t, b)
            lib_ms = library_time("torch.sparse.mm(sparse_coo_tensor of the "
                                  "entries, B)", coo_library, ref, 50)
            # the entries and B read once, C written once; one
            # multiply-add per entry and lane
            timing = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      **bound(12 * entries + 8 * rows * lanes,
                              2.0 * entries * lanes),
                      "library_ms": lib_ms}
    # the probe is K6's main path: counts set to 0 right before, read after
    zero_launches()
    reports = [probe.measure(entries, rows, lanes, dev)
               for lanes in probe.DEFAULT_LANES]
    reports.append(probe.measure(entries, rows, probe.DEFAULT_LANES[0], dev,
                                 hot_row=17))
    launches = read_launches()
    for rep in reports:
        log(f"  probe, lanes {rep['lanes']}"
            + (f", every entry in row {rep['hot_row']}"
               if rep["hot_row"] is not None else "")
            + f": entry_fma {rep['value']:.3f} ns per entry (kernel "
            f"{rep['kernel_ms'] * 1e3:.2f} us with the stream kept busy, "
            f"{rep['call_ms'] * 1e3:.2f} us a call); spmm_stream on the "
            f"same entries {rep['stream_kernel_ns']:.3f} ns per entry (kernel "
            f"{rep['stream_kernel_ms'] * 1e3:.2f} us, "
            f"{rep['stream_call_ms'] * 1e3:.2f} us a call; tile_m "
            f"{rep['stream_tile_m']}, cellmax {rep['stream_cellmax']}); "
            f"verdict: {rep['verdict']}. spmm_stream at its own shape "
            f"(phase 3): {k2_main:.3f} ns per entry")
        log("  " + json.dumps(rep))
    if launches["entry_fma"] < 1 or launches["spmm_stream"] < 1:
        raise AssertionError(f"the probe did not launch K6 and K2: "
                             f"{launches}")
    return {"name": "entry_fma", "route": "cuda",
            "source": "basic_sparse_matrix_tpu_torch/csrc/entry_fma.cu",
            "replaces": "benchmarks/entry_fma_probe.py:67",
            "launches": launches["entry_fma"], **timing}


def k7_phase(dev, launches: int) -> dict:
    """Phase 25: K7, the triangular solve's level step, against its plain
    version (four operations a level) and its bound where the benchmark
    runs it: the median level of IC(0) of HPCG's operator at 104³ (a wide
    launch), the dataflow chain of its forward solve (one launch), the
    longest narrow run of its nested-dissection factor at 32³ (one block),
    and both forward solves, each inside a CUDA graph
    (``probes/trsv_probe.py::hpcg_rows``, which also holds each solve to the
    plain version). ``launches`` is phase 6's count."""
    from basic_sparse_matrix_tpu_torch.probes import trsv_probe as probe

    log("trsv_level (K7) vs plain on the card (CUDA events around graph "
        "replays):")
    rows = {r["case"]: r for r in probe.hpcg_rows(dev)}
    for r in rows.values():
        log(f"  {r['case']}: {r['levels']} levels, {r['rows']} rows, "
            f"{r['entries']} entries: K7 {r['kernel_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms (bytes)")
    level = rows["104³ IC(0), median level"]
    keep = ("levels", "rows", "entries", "kernel_ms", "plain_ms", "bound_ms")
    return {"name": "trsv_level", "route": "cuda",
            "source": "basic_sparse_matrix_tpu_torch/csrc/trsv_level.cu",
            "replaces": "none (the JAX package's level step is plain jnp)",
            "launches": launches, "ms": level["kernel_ms"],
            "plain_ms": level["plain_ms"], "bound_ms": level["bound_ms"],
            "bound_by": "bytes",
            "cases": {name: {k: r[k] for k in keep}
                      for name, r in rows.items()}}


# ---- 19. the distributed layer (parallel/) on logical shards and NCCL -----
PAR_SHARDS = 4            # (a), (c), (d): logical ranks on the one card
PAR_SERVING_SHARDS = 8    # (b): rps 4,493 at n = 35,937
# Fixed iteration counts of (b) (the sharded solvers run a fixed count, as
# the JAX package's): CG reaches ≈ 1e-5 near 90 steps and PCG near 27 on
# the 33³ Laplacian at 8 shards; Chebyshev with Lanczos(32) bounds 7.6e-5
# at 100 (the port's CPU rehearsal).
PAR_CG_ITERS = 110
PAR_PCG_ITERS = 40
PAR_CHEB_ITERS = 150
PAR_RES_MAX = 1e-5
PAR_CHEB_RES_MAX = 1e-4
PAR_RITZ_REL = 1e-4
PAR_VALUES_RTOL = 1e-5


def on_card(name: str, *tensors) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise AssertionError(f"{name}: a result lies on {t.device}")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return int(sock.getsockname()[1])


def parallel_spmm(a_st, b_st, ref) -> dict:
    """19(a): the four SpMM strategies on the 1M × 1M × 32 × 512 operand at
    4 logical shards (2 × 2 for the 2-D ring), each held to phase 4's
    ``mul_dense`` result; host shard and plan times, CUDA-event ms, K1/K2
    launches per call. Returns the ms by strategy."""
    from basic_sparse_matrix_tpu_torch import mul_dense
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
    from basic_sparse_matrix_tpu_torch.parallel import sharded as sh
    from basic_sparse_matrix_tpu_torch.parallel import spmm as ps
    from basic_sparse_matrix_tpu_torch.parallel import spmm2d
    from basic_sparse_matrix_tpu_torch.parallel.mesh import make_mesh, row_mesh
    from basic_sparse_matrix_tpu_torch.runtime.timing import cuda_time_ms

    s = PAR_SHARDS
    mesh = row_mesh(s, comm="local")
    mesh2 = make_mesh((2, 2), ("rows", "cols"), comm="local")
    (sa, sa2), t_shard = timed(lambda: tuple(
        sh.put_sharded(sh.shard_csr(a_st, r), m)
        for r, m in ((s, mesh), (2, mesh2))))
    log(f"  shard_csr + put_sharded at {s} and 2 row shards: {t_shard:.2f} s "
        f"(host); rps {sa.rows_per_shard}, nnz_max "
        f"{int(sa.indices.shape[1])}; on {sa.device}")
    # K2 once per rank (and ring step) in a call: every local product took
    # spmm_auto's streaming rung
    runs = {"spmm_sharded": (lambda: ps.spmm_sharded(sa, b_st, mesh), s),
            "spmm_allgather": (lambda: ps.spmm_allgather(sa, b_st, mesh), s),
            "spmm_ring": (lambda: ps.spmm_ring(sa, b_st, mesh), s * s),
            "spmm_ring_2d": (lambda: spmm2d.spmm_ring_2d(sa2, b_st, mesh2),
                             2 * 2 * 2)}
    ms = {}
    for name, (run, k2_want) in runs.items():
        before = (k1.LAUNCHES, k2.LAUNCHES)
        out, first = timed(run)
        got = (k1.LAUNCHES - before[0], k2.LAUNCHES - before[1])
        on_card(name, out)
        compare(f"{name} at {s} logical shards vs mul_dense",
                sh.unshard_rows(out, a_st.rows), ref)
        del out
        if got != (0, k2_want):
            raise AssertionError(f"{name}: (K1, K2) launched {got} times in "
                                 f"a call, expected (0, {k2_want}): one K2 "
                                 f"per rank and ring step")
        ms[name] = cuda_time_ms(run, warmup=0, iters=3)
        log(f"  {name}: first call (host plans included) {first:.2f} s; "
            f"{ms[name]:.3f} ms a call (CUDA events, median of 3); "
            f"launches a call K1 {got[0]}, K2 {got[1]}")
    ms["mul_dense"] = cuda_time_ms(lambda: mul_dense(a_st, b_st), warmup=0,
                                   iters=3)
    log(f"  single-device mul_dense on the same operand: "
        f"{ms['mul_dense']:.3f} ms a call (CUDA events, median of 3)")
    return ms, (sa, sa2, b_st, mesh, mesh2)


def nccl_up() -> None:
    """An NCCL process group of world size 1 on a free local port."""
    import datetime

    import torch.distributed as dist

    port = free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    log(f"  NCCL process group up: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}, tcp://127.0.0.1:{port}")


def nccl_ring(a_st, b_st) -> None:
    """19(e), first half: ``spmm_ring`` through ``TorchDistComm`` over NCCL
    at world size 1 against ``LocalComm`` at one shard, bit for bit (the
    process group stays up for the CG half in :func:`parallel_serving`)."""
    from basic_sparse_matrix_tpu_torch.parallel import sharded as sh
    from basic_sparse_matrix_tpu_torch.parallel import spmm as ps
    from basic_sparse_matrix_tpu_torch.parallel.comm import TorchDistComm
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    nccl_up()
    mesh_d, mesh_l = row_mesh(comm="dist"), row_mesh(1, comm="local")
    if not isinstance(mesh_d.axis("rows"), TorchDistComm):
        raise AssertionError("row_mesh(comm='dist') is not on TorchDistComm")
    # one shard object serves both meshes: they hold shard 0 on the card
    sa = sh.put_sharded(sh.shard_csr(a_st, 1), mesh_l)
    y_l, first = timed(lambda: ps.spmm_ring(sa, b_st, mesh_l))
    y_d, again = timed(lambda: ps.spmm_ring(sa, b_st, mesh_d))
    on_card("spmm_ring over NCCL", y_d)
    same = bool(torch.equal(y_d, y_l))
    log(f"  spmm_ring at world size 1: LocalComm {first:.2f} s (plans "
        f"included), TorchDistComm/NCCL {again * 1e3:.1f} ms; bitwise "
        f"equal: {same}")
    if not same:
        raise AssertionError("spmm_ring over NCCL differs from LocalComm")


def parallel_serving(dev) -> None:
    """19(b)-(f): DistributedOperator on the 33³ Laplacian at 8 logical
    shards, TSQR at 2²⁰ × 64 and sharded SpGEMM on phase 16's operands at
    4, CG over NCCL against LocalComm, and the dry run at 8."""
    import importlib

    import torch.distributed as dist

    from basic_sparse_matrix_tpu_torch import CSR, SparseOperator
    from basic_sparse_matrix_tpu_torch.models import tsqr
    from basic_sparse_matrix_tpu_torch.models.lanczos import (
        LanczosSetup, _ritz_values)
    from basic_sparse_matrix_tpu_torch.parallel import lanczos as pl
    from basic_sparse_matrix_tpu_torch.parallel import spgemm_sparse as psg
    from basic_sparse_matrix_tpu_torch.parallel import tsqr as pts
    from basic_sparse_matrix_tpu_torch.parallel.dryrun import dryrun_multichip
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh
    from basic_sparse_matrix_tpu_torch.parallel.operator import (
        DistributedOperator)
    from basic_sparse_matrix_tpu_torch.runtime.timing import cuda_time_ms

    spg = importlib.import_module("basic_sparse_matrix_tpu_torch.ops.spgemm")

    # (b) serving on the 33³ Laplacian
    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)      # the default device
    on_card("the 33³ Laplacian", a.values)
    op, t_op = timed(lambda: DistributedOperator(
        a, row_mesh(PAR_SERVING_SHARDS, comm="local")))
    sop = SparseOperator(a)
    log(f"(b) DistributedOperator, 33³ Laplacian at {PAR_SERVING_SHARDS} "
        f"logical shards: sharded in {t_op:.3f} s, rps "
        f"{op.sa.rows_per_shard}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    x = torch.randn(n, generator=gen, device=dev)
    b8 = torch.randn((n, 8), generator=gen, device=dev)
    for name, got, want in (("matvec", op.matvec(x), sop.matvec(x)),
                            ("matmul (8 rhs)", op.matmul(b8),
                             sop.matmul(b8))):
        on_card(name, got)
        compare(f"DistributedOperator.{name} vs SparseOperator", got, want)
    log(f"  matvec {cuda_time_ms(lambda: op.matvec(x), warmup=1, iters=5):.3f}"
        f" ms, matmul (8 rhs) "
        f"{cuda_time_ms(lambda: op.matmul(b8), warmup=1, iters=5):.3f} ms "
        f"(CUDA events, median of 5); SparseOperator matmul "
        f"{cuda_time_ms(lambda: sop.matmul(b8), warmup=1, iters=5):.3f} ms")
    rhs = torch.randn(n, generator=gen, device=dev)

    def rel_res(xs):
        return float(torch.linalg.norm(rhs.double() - matvec64(a, xs))
                     / torch.linalg.norm(rhs.double()))
    _, t_lfac = timed(op._ensure_block_jacobi)
    log(f"  block-Jacobi factors: {tuple(op._lfac.shape)}, "
        f"{op._lfac.numel() * 4 / 2**20:.0f} MiB, built in {t_lfac:.3f} s")
    for name, iters in (("solve_cg", PAR_CG_ITERS),
                        ("solve_pcg", PAR_PCG_ITERS)):
        xs, t = timed(lambda: getattr(op, name)(rhs, iters=iters))
        on_card(name, xs)
        res = rel_res(xs)
        log(f"  {name}: {iters} iterations in {t * 1e3:.1f} ms "
            f"({t * 1e3 / iters:.2f} ms per iteration), float64 relative "
            f"residual {res:.3e} (limit {PAR_RES_MAX:g})")
        if not res <= PAR_RES_MAX:
            raise AssertionError(f"{name}: residual over the limit")
    log(f"  solve_cg at solve_pcg's {PAR_PCG_ITERS} iterations: float64 "
        f"relative residual "
        f"{rel_res(op.solve_cg(rhs, iters=PAR_PCG_ITERS)):.3e}")
    xs, t = timed(lambda: op.solve_chebyshev(rhs, iters=PAR_CHEB_ITERS))
    on_card("solve_chebyshev", xs)
    res = rel_res(xs)
    log(f"  solve_chebyshev: {PAR_CHEB_ITERS} iterations with bounds "
        f"{op._bounds[0]:.6f}, {op._bounds[1]:.6f} from eigen_values(32) "
        f"(first call, Lanczos included) {t * 1e3:.1f} ms; float64 relative "
        f"residual {res:.3e} (limit {PAR_CHEB_RES_MAX:g})")
    if not res <= PAR_CHEB_RES_MAX:
        raise AssertionError("solve_chebyshev: residual over the limit")
    _, t_eig = timed(lambda: op.eigen_values(32))
    v0 = torch.as_tensor(np.random.default_rng(SEED + 9).standard_normal(
        n).astype(np.float32), device=dev)
    sharded = pl.ritz_values(*pl.lanczos_sharded_from(
        op.sa, torch.nn.functional.pad(v0, (0, op.sa.padded_rows - n)), 32,
        op.mesh, n=n))
    single = _ritz_values(LanczosSetup.build(a), v0, 32)
    on_card("sharded Ritz values", sharded)
    for i, name in ((0, "min"), (-1, "max")):
        d = abs(float(sharded[i]) - float(single[i]))
        log(f"  Ritz {name} (k = 32, one seeded v0): sharded "
            f"{float(sharded[i]):.7f}, single-device {float(single[i]):.7f}, "
            f"|d| {d:.3e} (limit {PAR_RITZ_REL:g}·|λ|)")
        if not d <= PAR_RITZ_REL * abs(float(single[i])):
            raise AssertionError(f"sharded Lanczos: Ritz {name} off")
    log(f"  eigen_values(32): {t_eig * 1e3:.1f} ms")
    cs, t_sp = timed(lambda: op.matmul_sparse(a))
    ref, _ = timed(lambda: sop.matmul_sparse(a))
    same_csr(f"DistributedOperator.matmul_sparse(A) at "
             f"{PAR_SERVING_SHARDS} shards vs SparseOperator's", cs, ref)
    log(f"  matmul_sparse: first call (plans) {t_sp:.3f} s, cached "
        f"{timed(lambda: op.matmul_sparse(a))[1] * 1e3:.1f} ms")

    # (e), second half: CG over NCCL at world size 1
    op_d = DistributedOperator(a, row_mesh(comm="dist"))
    op_l = DistributedOperator(a, row_mesh(1, comm="local"))
    x_d, x_l = (o.solve_cg(rhs, iters=PAR_CG_ITERS) for o in (op_d, op_l))
    on_card("solve_cg over NCCL", x_d)
    same = bool(torch.equal(x_d, x_l))
    log(f"(e) solve_cg ({PAR_CG_ITERS} iterations) at world size 1: "
        f"TorchDistComm/NCCL bitwise equal to LocalComm: {same}")
    if not same:
        raise AssertionError("solve_cg over NCCL differs from LocalComm")
    dist.destroy_process_group()
    del op, sop, op_d, op_l

    # (c) TSQR at 2²⁰ × 64
    t_in = torch.randn(TSQR_SHAPE, generator=torch.Generator(
        device=dev).manual_seed(SEED + 9), device=dev)
    mesh = row_mesh(PAR_SHARDS, comm="local")
    (q, rr), t = timed(lambda: pts.tsqr_sharded(t_in, mesh))
    on_card("tsqr_sharded", q, rr)
    ad, qd = t_in.double(), q.double()
    res = float(torch.linalg.norm(ad - qd @ rr.double())
                / torch.linalg.norm(ad))
    orth = float((qd.T @ qd - torch.eye(TSQR_SHAPE[1], dtype=torch.float64,
                                         device=dev)).abs().max())
    del ad, qd
    log(f"(c) tsqr_sharded {TSQR_SHAPE[0]}x{TSQR_SHAPE[1]} at {PAR_SHARDS} "
        f"shards: ‖A − QR‖_F/‖A‖_F {res:.3e} (limit {TSQR_RES_MAX:g}), "
        f"max|QᵀQ − I| {orth:.3e} (limit {TSQR_ORTH_MAX:g})")
    if not (res <= TSQR_RES_MAX and orth <= TSQR_ORTH_MAX):
        raise AssertionError("tsqr_sharded: residual or orthogonality")
    ms = {name: cuda_time_ms(fn, warmup=1, iters=3) for name, fn in (
        ("tsqr_sharded", lambda: pts.tsqr_sharded(t_in, mesh)),
        ("tsqr", lambda: tsqr(t_in)),
        ("torch.linalg.qr", lambda: torch.linalg.qr(t_in)))}
    log("  " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + " (CUDA events, median of 3, one operand)")
    del t_in, q, rr

    # (d) sharded SpGEMM on phase 16's operands
    sa_, sb_ = (bench_csr(seed, PLANNED_N, SS_MUL_INSERTS, dev)
                for seed in (5000, 6000))
    plans, t_plan = timed(lambda: psg.plan_spgemm_sharded(sa_, sb_,
                                                          PAR_SHARDS))
    c_sh, t_num = timed(lambda: psg.spgemm_sharded(sa_, sb_, mesh,
                                                    plans=plans))
    same_csr(f"(d) spgemm_sharded (n {PLANNED_N}, {PAR_SHARDS} shards) vs "
             f"spgemm_planned", c_sh, spg.spgemm_planned(sa_, sb_))
    log(f"  plans {t_plan:.3f} s (host), numeric + assembly "
        f"{t_num * 1e3:.1f} ms (host clock, synchronised)")

    # (f) the dry run on the card
    _, t = timed(lambda: dryrun_multichip(8))
    log(f"(f) dryrun_multichip(8) on {dev}: ran to its end in {t:.2f} s")


def same_csr(name: str, got, want) -> None:
    """Pattern entry for entry, values within PAR_VALUES_RTOL of max|ref|."""
    on_card(name, got.values, got.indices)
    gp, gi, gv = got.numpy()
    wp, wi, wv = want.numpy()
    if not (got.shape == want.shape and np.array_equal(gp, wp)
            and np.array_equal(gi, wi)):
        raise AssertionError(f"{name}: the pattern differs")
    err = float(np.abs(gv - wv).max()) if wv.size else 0.0
    scale = float(np.abs(wv).max()) if wv.size else 1.0
    log(f"  {name}: pattern equal ({wv.size} entries), max abs err "
        f"{err:.3e} (limit {PAR_VALUES_RTOL:g}·max|ref| = "
        f"{PAR_VALUES_RTOL * scale:.3e})")
    if not err <= PAR_VALUES_RTOL * scale:
        raise AssertionError(f"{name}: values differ")


def parallel_phase(dev, a_st, b_st, ref) -> tuple:
    """Phase 19: the distributed layer on the card; the launch counts are
    set to 0 right before and read right after. The phase runs under
    ``eager_loops()``, as it ran before its programs were graphed (phase
    24 replays them). Returns (a)'s ms and the rings' operands (phase
    24(f))."""
    log("parallel/ (phase 19): logical shards on one card (LocalComm), "
        "NCCL at world size 1 (TorchDistComm):")
    t0 = time.perf_counter()
    base = fresh_peak()
    zero_launches()
    with eager_loops():
        ms, ring = parallel_spmm(a_st, b_st, ref)
        log_peak("  (a) SpMM strategies", base)
        nccl_ring(a_st, b_st)
        parallel_serving(dev)
    launches = read_launches()
    log(f"  phase 19 launches: {launches}; {time.perf_counter() - t0:.1f} s")
    if launches["spmm_stream"] < 1:
        raise AssertionError("phase 19 launched no K2")
    return ms, ring


# ---- 20. parallel/: the distributed direct solvers and BCR -----------------
DIRECT_SHARDS = 4               # logical ranks on the one card
DIRECT_FACTOR_ATOL_OF_MAX = 1e-5  # sharded factor vs the single-device one
NCCL_ATOL_OF_MAX = 1e-6         # NCCL vs LocalComm where atomics may reorder


def close_of_max(name: str, got, want, frac: float) -> float:
    """``max|got - want| <= frac·max|want|``; returns the max abs error."""
    on_card(name, got)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"  {name}: max abs err {err:.3e} (limit {frac:g}·max|ref| = "
        f"{frac * scale:.3e}), bitwise equal {bool(torch.equal(got, want))}")
    if not err <= frac * scale:
        raise AssertionError(f"{name}: over the limit")
    return err


def dist_solves(fwd, bwd, b, mesh):
    """Distributed forward solve on ``fwd``, then backward on the mirrored
    schedule ``bwd`` (``b`` and the solution flipped, as
    ``solve_sparse_distributed(lower=False)`` does)."""
    from basic_sparse_matrix_tpu_torch.parallel import triangular as pt

    y = pt.solve_triangular_sharded(fwd, b, mesh)
    return torch.flip(pt.solve_triangular_sharded(bwd, torch.flip(y, (0,)),
                                                  mesh), (0,))


def single_solves(l, fwd, bwd, b):
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st

    y = st.solve_triangular_sparse(l, b, fwd)
    return st.solve_triangular_sparse(l, y, bwd, lower=False)


def solve_pair(label: str, l, a, x_true, b8, mesh, single) -> dict:
    """The distributed solves on the factor ``l`` of ``a``: once through
    ``solve_sparse_distributed`` (schedules built inside), then on schedules
    built once, 1 and 8 right-hand sides, each checked and timed beside the
    single-device solves (``single = (l, fwd, bwd)``); ms by name."""
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st
    from basic_sparse_matrix_tpu_torch.parallel import triangular as pt

    b1 = b8[:, 0].contiguous()

    @eagerly
    def entry():
        y = pt.solve_sparse_distributed(l, b1, mesh, lower=True)
        return pt.solve_sparse_distributed(l.transpose(), y, mesh,
                                           lower=False)
    x, t_entry = timed(entry)
    on_card(f"{label} solve_sparse_distributed", x)
    check_solution(f"{label} solve_sparse_distributed, 1 rhs", a, x, x_true,
                   b8)
    (fwd, bwd), t_sched = timed(lambda: (
        st.build_schedule(l, lower=True),
        st.build_schedule(l.transpose(), lower=False)))
    ms = {"entry_1rhs_s": t_entry, "schedules_s": t_sched}
    for name, b in (("1 rhs", b1), ("8 rhs", b8)):
        runs = [timed(eagerly(lambda: dist_solves(fwd, bwd, b, mesh)))
                for _ in range(2)]
        x = runs[-1][0]
        check_solution(f"{label} distributed solve {name}", a, x, x_true, b)
        xs, t_single = timed(lambda: single_solves(*single, b))
        compare(f"{label} distributed solve {name} vs single-device", x, xs)
        ms[name] = [t * 1e3 for _, t in runs]
        ms[f"{name} single"] = t_single * 1e3
        log(f"  {label} solve {name} at {DIRECT_SHARDS} shards: "
            + " / ".join(f"{t:.1f}" for t in ms[name])
            + f" ms host clock (synchronised), single device "
            f"{t_single * 1e3:.1f} ms; levels fwd {fwd.n_levels}, bwd "
            f"{bwd.n_levels}")
    log(f"  {label}: solve_sparse_distributed forward + backward, 1 rhs, "
        f"schedules built inside: {t_entry:.3f} s; the two schedules "
        f"alone {t_sched:.3f} s (host)")
    return ms


def supernodal_sharded(dev, mesh) -> dict:
    """20(a): the 33³ Laplacian under ND, factorize_supernodal_sharded at
    4 logical shards against factorize_supernodal on the same schedule,
    then the distributed solves; K3 and the add-back's rect entry must
    launch, the rect entry once per routed level."""
    from basic_sparse_matrix_tpu_torch import CSR, prepare_direct
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.reorder import permute_symmetric
    from basic_sparse_matrix_tpu_torch.parallel import supernodal as ps

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)      # the default device
    on_card("the 33³ Laplacian", a.values)
    use_config(ordering="nd")
    base = fresh_peak()
    solver, setup = timed(lambda: prepare_direct(a))
    if solver.kind != "supernodal":
        raise AssertionError(f"tier {solver.kind!r}, expected supernodal")
    sched = solver.sched
    ap = permute_symmetric(a, solver.perm)
    log(f"(a) supernodal, 33³ Laplacian under ND: single-device set-up "
        f"{setup:.3f} s ({log_timings(solver.timings)}); {sched.n_groups} "
        f"groups, nnz_l {sched.nnz_l}")
    # eager, as the sharded factorization runs (this is the schedule's
    # second call, which would capture)
    single, t_single = timed(eagerly(lambda: sn.factorize_supernodal(
        sched, ap.values)))
    levels = rect_levels(sched)
    x_true, b8 = seeded_system(ap, SEED + 20)
    zero_launches()
    lv, t_dist = timed(eagerly(lambda: ps.factorize_supernodal_sharded(
        sched, ap.values, mesh)))
    launches = read_launches()
    close_of_max(f"factorize_supernodal_sharded at {DIRECT_SHARDS} shards vs "
                 f"factorize_supernodal", lv, single,
                 DIRECT_FACTOR_ATOL_OF_MAX)
    log(f"  numeric: sharded {t_dist * 1e3:.1f} ms, single device "
        f"{t_single * 1e3:.1f} ms (host clock, synchronised); launches "
        f"{launches}; levels routed to the rect entry {levels}")
    if launches["runs_read"] < 1:
        raise AssertionError("the sharded supernodal factorization launched "
                             "no K3")
    check_rects("the sharded supernodal factorization", launches, levels)
    l, t_asm = timed(lambda: sn.assemble_factor(ap, lv, sched))
    log(f"  assemble_factor {t_asm:.3f} s (host)")
    ms = solve_pair("(a) supernodal", l, ap, x_true, b8, mesh,
                    (solver._l, solver._fwd, solver._bwd))
    log_peak("(a) supernodal", base)
    use_config()
    return {"launches": launches, "numeric_ms": t_dist * 1e3,
            "single_ms": t_single * 1e3, **ms}


def scatter_sharded(dev, mesh) -> dict:
    """20(b): the 10⁶-node tree Laplacian + I under RCM, factorize_sharded
    at 4 logical shards against factorize, then the distributed solves."""
    from basic_sparse_matrix_tpu_torch import CSR, prepare_direct
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.ops.reorder import permute_symmetric
    from basic_sparse_matrix_tpu_torch.parallel import cholesky as pc

    n, r, c, v = tree_laplacian(TREE_N, SEED + 5)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    use_config(ordering="rcm")
    base = fresh_peak()
    solver, setup = timed(lambda: prepare_direct(a))
    if solver.kind != "scatter":
        raise AssertionError(f"tier {solver.kind!r}, expected scatter")
    sched = solver.sched
    ap = permute_symmetric(a, solver.perm)
    log(f"(b) scatter-list, tree Laplacian + I, n {n} under RCM: "
        f"single-device set-up {setup:.3f} s ({log_timings(solver.timings)});"
        f" {sched.n_levels} levels, {sched.n_triples} triples")
    single, t_single = timed(eagerly(lambda: sc.factorize(sched,
                                                          ap.values)))
    lv, t_dist = timed(eagerly(lambda: pc.factorize_sharded(
        sched, ap.values, mesh)))
    close_of_max(f"factorize_sharded at {DIRECT_SHARDS} shards vs factorize",
                 lv, single, DIRECT_FACTOR_ATOL_OF_MAX)
    log(f"  numeric: sharded {t_dist * 1e3:.1f} ms, single device "
        f"{t_single * 1e3:.1f} ms (host clock, synchronised)")
    x_true, b8 = seeded_system(ap, SEED + 21)
    l, t_asm = timed(lambda: sc.csc_to_csr_l(sched, lv))
    log(f"  csc_to_csr_l {t_asm:.3f} s (host)")
    ms = solve_pair("(b) scatter-list", l, ap, x_true, b8, mesh,
                    (solver._l, solver._fwd, solver._bwd))
    log_peak("(b) scatter-list", base)
    use_config()
    return {"numeric_ms": t_dist * 1e3, "single_ms": t_single * 1e3, **ms}


def bcr_sharded(dev, mesh) -> dict:
    """20(c): the 33³ Laplacian under RCM (nb 840, 43 block rows padded to
    64 = 4·16), bcr_solve_sharded_csr at 1 and 8 right-hand sides against
    the single-device BCRSolver."""
    from basic_sparse_matrix_tpu_torch import CSR, prepare_direct
    from basic_sparse_matrix_tpu_torch.models.banded import (
        bandwidth, block_size_for)
    from basic_sparse_matrix_tpu_torch.ops.reorder import permute_symmetric
    from basic_sparse_matrix_tpu_torch.parallel import bcr as pb

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    use_config(ordering="rcm", banded_solver="bcr")
    base = fresh_peak()
    solver, setup = timed(lambda: prepare_direct(a))
    ap = permute_symmetric(a, solver.perm)
    nb = block_size_for(bandwidth(ap), n)
    if solver.kind != "banded-bcr" or nb != BANDED_NB:
        raise AssertionError(f"tier {solver.kind!r}, nb {nb}")
    x_true, b8 = seeded_system(ap, SEED + 22)
    log(f"(c) BCR, 33³ Laplacian under RCM: nb {nb}, {-(-n // nb)} block "
        f"rows, single-device set-up {setup:.3f} s "
        f"({log_timings(solver.timings)})")
    ms = {}
    for name, b in (("1 rhs", b8[:, 0].contiguous()), ("8 rhs", b8)):
        runs = [timed(eagerly(lambda: pb.bcr_solve_sharded_csr(ap, b,
                                                               mesh)))
                for _ in range(2)]
        x = runs[-1][0]
        on_card(f"bcr_solve_sharded_csr {name}", x)
        check_solution(f"(c) bcr_solve_sharded_csr {name}", ap, x, x_true,
                       b8)
        xs, t_single = timed(lambda: solver._banded.solve(b))
        compare(f"(c) bcr_solve_sharded_csr {name} vs BCRSolver", x, xs)
        ms[name] = [t * 1e3 for _, t in runs]
        ms[f"{name} single"] = t_single * 1e3
        log(f"  bcr_solve_sharded_csr {name} at {DIRECT_SHARDS} shards: "
            + " / ".join(f"{t:.1f}" for t in ms[name])
            + f" ms host clock (band_blocks on the host included), "
            f"BCRSolver.solve {t_single * 1e3:.1f} ms")
    log_peak("(c) BCR", base)
    use_config()
    return ms


def nccl_direct(dev) -> None:
    """20(d): at world size 1 over NCCL, the four distributed direct and
    BCR functions and the row-block SpMM against LocalComm at one shard,
    on the 14³ Laplacian."""
    import torch.distributed as dist

    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.reorder import (
        nd_permutation, permute_symmetric)
    from basic_sparse_matrix_tpu_torch.parallel import bcr as pb
    from basic_sparse_matrix_tpu_torch.parallel import cholesky as pc
    from basic_sparse_matrix_tpu_torch.parallel import multihost as mh
    from basic_sparse_matrix_tpu_torch.parallel import sharded as sh
    from basic_sparse_matrix_tpu_torch.parallel import spmm as psp
    from basic_sparse_matrix_tpu_torch.parallel import supernodal as ps
    from basic_sparse_matrix_tpu_torch.parallel import triangular as pt
    from basic_sparse_matrix_tpu_torch.parallel.comm import TorchDistComm
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    n, r, c, v = laplacian_3d(FORMULATION_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    ap = permute_symmetric(a, nd_permutation(a))
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    b8 = torch.randn((n, 8), generator=gen, device=dev)
    nccl_up()
    mesh_d, mesh_l = row_mesh(comm="dist"), row_mesh(1, comm="local")
    if not isinstance(mesh_d.axis("rows"), TorchDistComm):
        raise AssertionError("row_mesh(comm='dist') is not on TorchDistComm")
    log(f"(d) NCCL at world size 1 against LocalComm at one shard, 14³ "
        f"Laplacian (n {n}), with torch's deterministic algorithms on (a "
        f"CUDA index_add_ then sums in a fixed order, no atomics): bitwise "
        f"where nothing else adds with atomics, within "
        f"{NCCL_ATOL_OF_MAX:g}·max|ref| where the add-back kernel's "
        f"atomicAdd does:")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sched = sc.analyze(ap)
        f_d, f_l = (pc.factorize_sharded(sched, ap.values, m)
                    for m in (mesh_d, mesh_l))
        same_bits("factorize_sharded (deterministic index_add_)", f_d, f_l)
        fwd = st.build_schedule(sc.csc_to_csr_l(sched, f_l))
        y_d, y_l = (pt.solve_triangular_sharded(fwd, b8, m)
                    for m in (mesh_d, mesh_l))
        same_bits("solve_triangular_sharded (deterministic index_add_)",
                  y_d, y_l)
        ssn = sn.analyze_supernodal(ap)
        s_d, s_l = (ps.factorize_supernodal_sharded(ssn, ap.values, m)
                    for m in (mesh_d, mesh_l))
        close_of_max("factorize_supernodal_sharded (the add-back's "
                     "atomicAdd)", s_d, s_l, NCCL_ATOL_OF_MAX)
    finally:
        torch.use_deterministic_algorithms(False)
    # natural order: bandwidth 196, 14 blocks padded to 16
    x_d, x_l = (pb.bcr_solve_sharded_csr(a, b8, m, nb=FORMULATION_K ** 2)
                for m in (mesh_d, mesh_l))
    same_bits("bcr_solve_sharded (no atomics)", x_d, x_l)

    def builder(spec):
        keep = (r >= spec.row_start) & (r < spec.row_end)
        return CSR.from_coo_arrays((spec.row_end - spec.row_start, n),
                                   r[keep] - spec.row_start, c[keep], v[keep])
    sa = mh.build_global_sharded_csr(mh.local_row_block(n, n), builder)
    log(f"  build_global_sharded_csr at world size 1: shards {sa.shards}, "
        f"nnz {sa.nnz}")
    same_bits("build_global_sharded_csr + spmm_sharded (no atomics)",
              psp.spmm_sharded(sa, b8, mh.global_row_mesh()),
              psp.spmm_sharded(sh.put_sharded(sh.shard_csr(a, 1), mesh_l),
                               b8, mesh_l))
    dist.destroy_process_group()


def same_bits(name: str, got, want) -> None:
    on_card(name, got)
    same = bool(torch.equal(got, want))
    log(f"  {name}: bitwise equal to LocalComm {same}")
    if not same:
        raise AssertionError(f"{name}: NCCL differs from LocalComm")


def direct_parallel_phase(dev) -> dict:
    """Phase 20: the distributed direct solvers and BCR on the card at full
    width (4 logical shards), NCCL at world size 1, the dry run; returns
    (a)'s launch counts. The sharded calls run under ``eager_loops()``, as
    they ran before they were graphed (phase 24 replays them)."""
    from basic_sparse_matrix_tpu_torch.parallel.dryrun import dryrun_multichip
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    log(f"parallel/ direct solvers (phase 20): {DIRECT_SHARDS} logical "
        f"shards on one card (LocalComm), NCCL at world size 1:")
    mesh = row_mesh(DIRECT_SHARDS, comm="local")
    out = {}
    for name, part in (("supernodal", supernodal_sharded),
                       ("scatter", scatter_sharded), ("bcr", bcr_sharded)):
        t0 = time.perf_counter()
        out[name] = part(dev, mesh)
        torch.cuda.empty_cache()
        log(f"  [{name}: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    eagerly(lambda: nccl_direct(dev))()
    log(f"  [nccl: {time.perf_counter() - t0:.1f} s]")
    _, t = timed(eagerly(lambda: dryrun_multichip(8)))
    log(f"(e) dryrun_multichip(8) on {dev}, the direct and BCR steps "
        f"included: ran to its end in {t:.2f} s")
    log("phase 20 summary: " + json.dumps(out, default=float))
    return out["supernodal"]["launches"]



# ---- 21. batched values: one schedule, many numeric systems ----------------
BATCH = 8                       # (a) and (d): systems of one pattern
BATCH_TREE = 4                  # (b)
BATCH_RHS = 4                   # (c): right-hand-side blocks
BATCH_RHS_COLS = 128
BATCH_FACTOR_ATOL_OF_MAX = 1e-4  # batched vs one-system factor (atomics)


def shifted_values(a, bt: int, seed: int) -> torch.Tensor:
    """``bt`` value sets ``A + c_b·I`` of ``a``'s pattern on its device,
    ``c_b`` uniform in [0, 1) from the seed: one pattern, every system
    SPD. (bt, nnz) float32."""
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(rng.random(bt).astype(np.float32), device=a.device)
    eye = (a.indices.long() == a.row_ids().long()).float()
    return a.values.float()[None] + c[:, None] * eye[None]


def with_values(a, values):
    """The CSR of ``a``'s pattern holding ``values``."""
    from basic_sparse_matrix_tpu_torch import CSR

    return CSR(a.indptr, a.indices, values, a.rows, a.cols)


def solve_value_orders(solver):
    """The CSR orders of the factor's and its transpose's values from the
    schedule's CSC order (host argsorts, once per pattern) and
    ``l.transpose()``."""
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st

    rows, cols = st.factor_pattern(solver.sched)
    lt = solver._l.transpose()
    return (st.csr_value_order(rows, cols, solver._l),
            st.csr_value_order(cols, rows, lt), lt)


def batched_solve_values(solver, lv, orders):
    """The batched triangular solves' values of factors ``lv`` (Bt, nnz_l)
    in the schedule's CSC order, on the solver's schedules (built once from
    its own factor, whose pattern they share): (forward, backward) value
    pairs."""
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st

    fwd_order, bwd_order, _ = orders
    return (st.schedule_values(solver._fwd, lv[:, fwd_order]),
            st.schedule_values(solver._bwd, lv[:, bwd_order]))


def batched_solves(solver, lt, vf, vb, b):
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st

    y = st.solve_triangular_sparse(solver._l, b, solver._fwd, values=vf)
    return st.solve_triangular_sparse(lt, y, solver._bwd, lower=False,
                                      values=vb)


def batched_factor_and_solve(label: str, solver, ap, factorize, bt: int,
                             seed: int) -> dict:
    """Factor ``bt`` shifted value sets of ``ap``'s pattern on the solver's
    schedule at once (launch counts set to 0 right before, read right
    after) and one by one; hold each batched factor to its own one-system
    factor; solve 8 right-hand sides a system with the batched triangular
    solves and check each system's errors; time the batch against the
    single calls."""
    sched = solver.sched
    vals = shifted_values(ap, bt, seed)
    base = fresh_peak()
    zero_launches()
    lv, t_batch = timed(lambda: factorize(sched, vals))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    on_card(f"{label} batched factor", lv)
    singles, t_single = [], []
    zero_launches()
    for b in range(bt):
        one, t = timed(lambda: factorize(sched, vals[b]))
        singles.append(one)
        t_single.append(t)
        if b == 0:
            one_launches = read_launches()
    if lv.shape != (bt, sched.nnz_l):
        raise AssertionError(f"{label}: batched factor {tuple(lv.shape)}")
    errs = [close_of_max(f"{label} system {b}: batched factor vs its own",
                         lv[b], singles[b], BATCH_FACTOR_ATOL_OF_MAX)
            for b in range(bt)]
    del singles
    log(f"  {label}: numeric, {bt} systems at once {t_batch * 1e3:.1f} ms, "
        f"{bt} single calls {sum(t_single) * 1e3:.1f} ms ("
        + " / ".join(f"{t * 1e3:.1f}" for t in t_single)
        + f"); launches of the batch {launches}, of one system "
        f"{one_launches}; peak {peak / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB held before")
    kern = ("runs_read", "addback_resident", "panel_addback")
    if [launches[k] for k in kern] != [one_launches[k] for k in kern]:
        raise AssertionError(f"{label}: the batch launched {launches}, one "
                             f"system {one_launches}")

    orders, t_orders = timed(lambda: solve_value_orders(solver))
    lt = orders[2]
    (vf, vb), t_vals = timed(lambda: batched_solve_values(solver, lv, orders))
    gen = torch.Generator(device=ap.device).manual_seed(seed + 1)
    x_true = torch.randn((bt, ap.rows, 8), generator=gen,
                         dtype=torch.float64, device=ap.device)
    mats = [with_values(ap, vals[b]) for b in range(bt)]
    rhs = torch.stack([matvec64(mats[b], x_true[b]).float()
                       for b in range(bt)])
    runs = [timed(lambda: batched_solves(solver, lt, vf, vb, rhs))
            for _ in range(2)]
    x = runs[-1][0]
    on_card(f"{label} batched solve", x)
    for b in range(bt):
        check_solution(f"{label} system {b}, batched solve, 8 rhs", mats[b],
                       x[b], x_true[b], rhs[b])
    one_ms = []
    for b in range(bt):
        xb, t = timed(lambda: batched_solves(
            solver, lt, tuple(v[b: b + 1] for v in vf),
            tuple(v[b: b + 1] for v in vb), rhs[b: b + 1]))
        compare(f"{label} system {b}: batched solve vs its own", x[b],
                xb[0])
        one_ms.append(t * 1e3)
    log(f"  {label}: solve values: host orders {t_orders:.3f} s, device "
        f"gather {t_vals:.3f} s; solve of {bt} × 8 rhs "
        + " / ".join(f"{t * 1e3:.1f}" for _, t in runs)
        + f" ms, {bt} single solves (a batch of one each) "
        f"{sum(one_ms):.1f} ms (" + " / ".join(f"{t:.1f}" for t in one_ms)
        + ") host clock (synchronised)")
    return {"operands": {"vf": vf, "vb": vb, "rhs": rhs, "x_true": x_true,
                         "mats": mats, "orders": orders, "ap": ap},
            "numeric_ms": t_batch * 1e3,
            "single_numeric_ms": sum(t_single) * 1e3,
            "solve_ms": [t * 1e3 for _, t in runs],
            "single_solve_ms": sum(one_ms), "peak_gib": peak / 2**30,
            "launches": {k: launches[k] for k in kern},
            "max_abs_err": max(errs)}


def batched_kernels_vs_plain(solver, gen) -> dict:
    """K3 and the add-back's rect entry with a batch axis (Bt = 8) at phase
    7's operands, each against its plain version on the card, timed in
    turns plain-kernel-kernel-plain and device only; bound of 8 systems'
    bytes. Returns ``{name: batched entry}``."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
    from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3
    from basic_sparse_matrix_tpu_torch.probes.addback_probe import (
        seeded_rects)
    from basic_sparse_matrix_tpu_torch.probes.entry_fma_probe import (
        device_time_ms)

    sched = solver.sched
    scratch = sched.nnz_l
    one = padded_factor(solver)
    scale = torch.linspace(1.0, 2.0, BATCH, device=one.device)[:, None]
    lvals = (one[None] * scale).contiguous()
    tab = sn._TABLE_INDEX
    out = {}

    def slots(gi):
        _, u, w = sched.tabs[gi][tab["upd_base"]].shape
        return u * w
    cands = [gi for gi in range(sched.n_groups)
             if slots(gi) <= sn._KREAD_CR_CAP]
    gi = max(cands, key=lambda g: slots(g) * sn._kread_lpad(
        sched.tabs[g][tab["upd_irows"]].shape[2]))
    base = sched.tabs[gi][tab["upd_base"]][0].long()
    lp = sn._kread_lpad(int(sched.tabs[gi][tab["upd_irows"]].shape[2]))
    stf = torch.where(base != scratch, base, -1).reshape(-1).to(torch.int32)
    got = k3.runs_read(lvals, stf, lp)
    torch.cuda.synchronize()
    if not torch.equal(got, k3.runs_read_reference(lvals, stf, lp)):
        raise AssertionError("batched runs_read differs from its plain "
                             "version")
    if not torch.equal(got[3], k3.runs_read(lvals[3], stf, lp)):
        raise AssertionError("batched runs_read differs from its one-system "
                             "launch")
    del got
    ms, plain_ms, four = time_pair(lambda: k3.runs_read(lvals, stf, lp),
                                   lambda: k3.runs_read_reference(
                                       lvals, stf, lp), 20)
    dev_ms = min(device_time_ms(lambda: k3.runs_read(lvals, stf, lp), 50)
                 for _ in range(2))
    n_live = int((stf >= 0).sum())
    out["runs_read"] = {
        "bt": BATCH, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        **bound(4 * (stf.numel() + BATCH * (
            min(n_live * lp, lvals.shape[1]) + stf.numel() * lp)), 0.0)}
    log(f"  runs_read, {BATCH} systems at once (group {gi}, {stf.numel()} "
        f"runs of l_pad {lp}): equal to the plain version and to the "
        f"one-system launch; a call {four[1]:.4f} / {four[2]:.4f} ms, plain "
        f"{four[0]:.4f} / {four[3]:.4f} ms, device only {dev_ms:.4f} ms; "
        f"bound {out['runs_read']['bound_ms']:.4f} ms")

    launch = k4.addback_rects
    for name, g in zip(("addback_resident", "panel_addback"),
                       addback_groups(sched)):
        tcp, tnr, twd = (sched.tabs[g][tab[t]][0].long()
                         for t in ("tgt_cp", "tgt_nrows", "tgt_w"))
        p = torch.stack([seeded_rects(tcp, tnr, twd, sched.delta_rmax[g], gen)
                         for _ in range(BATCH)])
        live = int((p != 0).sum())
        timing = addback_vs_plain(
            f"{launch.__name__}, {BATCH} systems at once (group {g}, p "
            f"{tuple(p.shape)}, {live} live elements)", lvals,
            lambda lv: launch(lv, p, tcp, tnr, twd),
            lambda lv: k4.addback_rects_reference(lv, p, tcp, tnr, twd))
        one_sys = launch(lvals[5].clone(), p[5], tcp, tnr, twd)
        both = launch(lvals.clone(), p, tcp, tnr, twd)[5]
        torch.cuda.synchronize()
        err = float((both - one_sys).abs().max())
        if err > ADDBACK_TOL * max(1.0, float(one_sys.abs().max())):
            raise AssertionError(f"{name}: batched rect entry differs from "
                                 f"its one-system launch by {err:.3e}")
        touched = sum(min(int((p[b] != 0).sum()), lvals.shape[1])
                      for b in range(BATCH))
        tables = tcp.numel() + 2 * tnr.numel()
        out[name] = {"bt": BATCH, "ms": timing["ms"],
                     "device_ms": timing["device_ms"],
                     "plain_ms": timing["plain_ms"],
                     **bound(4 * (live + tables + 2 * touched), float(live)),
                     "max_abs_err": timing["max_abs_err"]}
        del p, one_sys, both
    return out


def batched_rhs_spmm(a_st, dev) -> dict:
    """21(c): ``mul_dense`` on phase 4's 1M × 1M × 32 operand with ``b`` of
    shape (4, 1M, 128): one K2 launch on the folded (1M, 512) RHS, each
    block against its own ``mul_dense``."""
    from basic_sparse_matrix_tpu_torch import mul_dense
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    b = torch.randn((BATCH_RHS, a_st.cols, BATCH_RHS_COLS), generator=gen,
                    device=dev)
    base = fresh_peak()
    mul_dense(a_st, b)                      # warm: the stream plan at 512
    zero_launches()
    out, t_batch = timed(lambda: mul_dense(a_st, b))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    on_card("batched mul_dense", out)
    if (launches["spmm_stream"], launches["spmm_bsr"]) != (1, 0):
        raise AssertionError(f"batched mul_dense launched {launches}, "
                             f"expected K2 once")
    single_ms = []
    for i in range(BATCH_RHS):
        mul_dense(a_st, b[i])               # warm: the plan at 128
        ref, t = timed(lambda: mul_dense(a_st, b[i]))
        single_ms.append(t * 1e3)
        compare(f"(c) block {i} of the batched mul_dense vs its own", out[i],
                ref)
    log(f"(c) mul_dense, 1M x 1M x 32, b {tuple(b.shape)}: "
        f"{t_batch * 1e3:.2f} ms at once (K2 {launches['spmm_stream']}, K1 "
        f"{launches['spmm_bsr']}), {BATCH_RHS} single calls "
        f"{sum(single_ms):.2f} ms (" + " / ".join(
            f"{t:.2f}" for t in single_ms) + ") host clock (synchronised); "
        f"peak {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} held")
    return {"ms": t_batch * 1e3, "single_ms": sum(single_ms),
            "k2_launches": launches["spmm_stream"], "peak_gib": peak / 2**30}


def batched_values_spmm(ap) -> dict:
    """21(d): ``spmm(a, b, values=V)`` with 8 value sets of the 33³
    Laplacian's pattern and 8 right-hand sides against ``spmm`` on each
    system's own CSR."""
    import importlib

    spmm_mod = importlib.import_module("basic_sparse_matrix_tpu_torch.ops.spmm")
    vals = shifted_values(ap, BATCH, SEED + 24)
    gen = torch.Generator(device=ap.device).manual_seed(SEED + 24)
    b = torch.randn((ap.cols, 8), generator=gen, device=ap.device)
    spmm_mod.spmm(ap, b, values=vals)
    out, t_batch = timed(lambda: spmm_mod.spmm(ap, b, values=vals))
    on_card("spmm(values=...)", out)
    mats = [with_values(ap, vals[i]) for i in range(BATCH)]
    refs, t_single = timed(lambda: [spmm_mod.spmm(m, b) for m in mats])
    for i in range(BATCH):
        compare(f"(d) system {i} of spmm(values=...) vs its own spmm",
                out[i], refs[i])
    log(f"(d) spmm(values=...), {BATCH} value sets of the {SOLVER_K}³ "
        f"Laplacian "
        f"({ap.stored} stored) x 8 rhs: {t_batch * 1e3:.3f} ms at once, "
        f"{BATCH} single calls {t_single * 1e3:.3f} ms host clock "
        f"(synchronised)")
    return {"ms": t_batch * 1e3, "single_ms": t_single * 1e3}


def eager_factorize(factorize):
    """``factorize`` run under :func:`eager_loops`: op by op, and not
    counted towards a capture."""
    def call(sched, values):
        with eager_loops():
            return factorize(sched, values)
    return call


def batched_values_phase(dev, solver, tree, gen) -> dict:
    """Phase 21 (a), (b), (d) and the batched kernels against their plain
    versions; (c) ran in the 1M-row operand's window. Returns the
    summary."""
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.reorder import permute_symmetric

    log(f"batched values (phase 21): one schedule, many numeric systems:")
    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)    # the default device
    ap = permute_symmetric(a, solver.perm)
    use_config(ordering="nd")
    out = {}
    t0 = time.perf_counter()
    # the factorizations as they ran before the numeric phases were
    # captured (phase 23 holds the graphs against these)
    out["supernodal"] = batched_factor_and_solve(
        f"(a) supernodal {SOLVER_K}³ ND, Bt {BATCH}", solver, ap,
        eager_factorize(sn.factorize_supernodal), BATCH, SEED + 22)
    log(f"  [(a): {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    out["kernels"] = batched_kernels_vs_plain(solver, gen)
    log(f"  [batched kernels: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    out["spmm_values"] = batched_values_spmm(ap)
    del a, ap
    torch.cuda.empty_cache()
    tree_solver, tree_a = tree
    use_config(ordering="rcm")
    out["scatter"] = batched_factor_and_solve(
        f"(b) scatter-list tree n {tree_a.rows}, Bt {BATCH_TREE}",
        tree_solver, permute_symmetric(tree_a, tree_solver.perm),
        eager_factorize(sc.factorize), BATCH_TREE, SEED + 23)
    log(f"  [(b), (d): {time.perf_counter() - t0:.1f} s]")
    use_config()
    return out

# ---- the compiled loops (phase 22) ------------------------------------------
GRAPH_RUNS = 5                  # eager runs and replays, in turns, per path
GRAPH_ATOL_OF_MAX = 1e-5        # replay vs eager loop (index_add_ atomics)
PCG_CHUNKS = (4, 8, 16)         # the chunk sizes measured; pcg.CHUNK is one
PCG_TOLS = (1e-6, 1e-5)         # the second only times the chunk sizes


@contextlib.contextmanager
def eager_loops():
    """The loops as they ran before they were captured: ``graphs.run``
    calls its function directly, so every level loop, numeric phase, PCG,
    Chebyshev, Lanczos and the QR iteration runs op by op (the eager
    reference of phases 21-23), and no call is counted towards a
    capture."""
    from basic_sparse_matrix_tpu_torch.runtime import graphs

    run = graphs.run
    graphs.run = lambda owner, tag, fn, *operands, **_: fn(*operands)
    try:
        yield
    finally:
        graphs.run = run


def eagerly(fn):
    def call():
        with eager_loops():
            return fn()
    return call


def ms_stats(seconds) -> dict:
    ms = sorted(t * 1e3 for t in seconds)
    return {"min": ms[0], "median": float(np.median(ms)), "max": ms[-1]}


def fmt_ms(st: dict) -> str:
    return f"{st['min']:.2f} / {st['median']:.2f} / {st['max']:.2f}"


# The ported kernels a captured program holds, by the names of their
# __global__ functions: K7 (run, wide, chain), K3, the add-back's rect
# entry, K2 (tile, sliced).
KERNEL_NAMES = {"trsv_level": ("trsv_run", "trsv_wide", "trsv_chain"),
                "runs_read": ("runs_read_kernel",),
                "addback_rects": ("addback_rects_kernel",),
                "spmm_stream": ("stream_spmm_kernel", "stream_sliced_kernel")}
# Parts of library kernel names that say which backend a dense factor took
# (cuSOLVER's potrf and geqrf, cuBLAS's trsm, MAGMA's own kernels).
LIBRARY_NAMES = ("potrf", "trsm", "geqrf", "orgqr", "larf", "magma")


def device_busy(fn) -> dict:
    """One ``fn()`` under ``torch.profiler`` (device activity only): the
    device operations it ran (kernels, copies, fills: for a replay, the
    launches its graphs hold), the ported kernels among them by name
    (``KERNEL_NAMES``), and their union of busy time over the synchronised
    host window of the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"device_ops": len(spans), "busy_share": busy * 1e-6 / wall,
            "profiled_ms": wall * 1e3,
            "kernels": {k: sum(any(n in e.name for n in names)
                               for e in events)
                        for k, names in KERNEL_NAMES.items()},
            "library": {k: n for k in LIBRARY_NAMES
                        if (n := sum(k in e.name.lower() for e in events))}}


def graph_vs_eager(name: str, graphed, check, eager=None,
                   capture_on: int = 1) -> dict:
    """The graphed calls up to the capturing one (``capture_on``: the first
    for the solves, the second for the numeric phases, Lanczos and QR; the
    capture = warm-up, capture, one replay) timed alone, with the peak
    above their start and the memory their graphs keep (static buffers and
    private pool: reserved bytes after ``empty_cache``); then
    ``GRAPH_RUNS`` eager calls (``eager``, by default ``graphed`` under
    ``eager_loops``) and replays in turns, the last replay held to the
    last eager result within ``GRAPH_ATOL_OF_MAX·max|ref|`` and passed to
    ``check``. Both return the tensor to hold."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    firsts = []
    for _ in range(capture_on):
        out, t = timed(graphed)
        firsts.append(t)
        del out
    first = firsts[0]
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_reserved() - reserved
    t_eager, t_graph = [], []
    for _ in range(GRAPH_RUNS):
        ref, t = timed(eager or eagerly(graphed))
        t_eager.append(t)
        out, t = timed(graphed)
        t_graph.append(t)
    err = close_of_max(f"{name}: replay vs eager loop", out, ref,
                       GRAPH_ATOL_OF_MAX)
    check(out)
    row = {"eager_ms": ms_stats(t_eager), "replay_ms": ms_stats(t_graph),
           "first_call_s": first, "graph_gib": kept / 2**30,
           "first_call_peak_gib": peak / 2**30, "max_abs_err": err,
           "profile": graphed}
    calls = (f"first call (warm-up + capture + replay) {first:.3f} s"
             if capture_on == 1 else
             f"first call (eager) {first:.3f} s, second (warm-up + capture "
             f"+ replay) {firsts[-1]:.3f} s")
    if capture_on > 1:
        row["capture_call_s"] = firsts[-1]
    log(f"  {name}: eager {fmt_ms(row['eager_ms'])} ms, replay "
        f"{fmt_ms(row['replay_ms'])} ms (min / median / max of "
        f"{GRAPH_RUNS}, in turns, synchronised host clock); {calls}; "
        f"graphs keep {kept / 2**30:.4f} GiB (static buffers + private "
        f"pool), peak of those calls {peak / 2**30:.4f} GiB above their "
        f"start")
    return row


def triangular_pair(fwd, bwd, values=None):
    """Forward + backward solves on the schedules ``fwd``/``bwd`` through
    ``solve_triangular_sparse``; ``values`` = batched (forward, backward)
    schedule values."""
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st

    vf, vb = values or (None, None)

    def solve(b):
        y = st.solve_triangular_sparse(None, b, fwd, values=vf)
        return st.solve_triangular_sparse(None, y, bwd, lower=False,
                                          values=vb)
    return solve


def direct_graphs(label: str, solver, a, x_true, b8, out: dict):
    """A direct solver's solve as ``DirectSolver.solve`` runs it (permute,
    forward, backward, permute back, the permutations gathers with the
    solver's device tensors) at 1 and 8 rhs, on fresh copies of its
    schedules (new graph owners, so the first call captures), graphed
    against eager and checked against phase 6's limits. Returns the
    copies."""
    import copy

    from basic_sparse_matrix_tpu_torch.ops.reorder import apply_perm

    fwd, bwd = copy.copy(solver._fwd), copy.copy(solver._bwd)
    pair = triangular_pair(fwd, bwd)

    def solve(b):
        if solver._gathers is None:
            return pair(b)
        to_p, from_p = solver._gathers
        return apply_perm(pair(apply_perm(b, to_p)), from_p)
    for name, b in (("1 rhs", b8[:, :1].contiguous()), ("8 rhs", b8)):
        key = f"{label} {name}"
        out[key] = graph_vs_eager(
            key, lambda b=b: solve(b),
            lambda x, b=b: check_solution(f"{key} replay", a, x, x_true, b))
        out[key]["levels"] = fwd.n_levels + bwd.n_levels
    return fwd, bwd


def pcg_graphs(dev, out: dict) -> None:
    """PCG on phase 12's input: at tol 1e-6 the graphed chunks of
    ``pcg.CHUNK`` iterations against the eager loop (equal iteration
    counts, float64 residual under phase 12's limit); at tol 1e-6 and
    1e-5 (a count that 8 and 16 do not divide) the replays at each of
    ``PCG_CHUNKS``, and the host-read loop whose triangular solves replay
    their graphs. Every count must equal the host-read loop's."""
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import pcg

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    b = torch.randn(n, generator=gen, device=dev)
    setup, t_setup = timed(lambda: pcg.PCGSetup.build(a))
    log(f"  PCG set-up (IC(0), schedules, ELL) {t_setup:.3f} s; "
        f"{setup.fwd.n_levels} levels each way; the first call at chunk "
        f"{PCG_CHUNKS[0]} also captures the two (n,) solve graphs")

    def check(x):
        res = float(torch.linalg.norm(b.double() - matvec64(a, x))
                    / torch.linalg.norm(b.double()))
        log(f"    float64 residual {res:.3e} (limit {PCG_RES_MAX:g})")
        if not res <= PCG_RES_MAX:
            raise AssertionError("graphed PCG: residual over the limit")

    def solve_at(chunk, tol, its):
        def solve():
            pcg.CHUNK = chunk
            x, it, _ = pcg.pcg_solve(a, b, tol=tol, setup=setup)
            its.append(it)
            return x
        return solve
    kept = pcg.CHUNK
    try:
        for tol in PCG_TOLS:
            (_, want, _), t = timed(lambda: pcg._pcg_loop(setup, b, tol,
                                                           1000))
            log(f"  PCG tol {tol:g}: the host-read loop (one read an "
                f"iteration, the solves replayed) {want} iterations in "
                f"{t * 1e3:.2f} ms")
            for chunk in PCG_CHUNKS:
                its = []
                key = f"PCG tol {tol:g}, chunk {chunk}"
                solve = solve_at(chunk, tol, its)
                if tol == PCG_TOLS[0] and chunk == kept:
                    def eager(tol=tol, its=its):
                        x, it, _ = pcg._pcg_loop(setup, b, tol, 1000)
                        its.append(it)
                        return x
                    row = graph_vs_eager(key, solve, check, eagerly(eager))
                else:
                    solve()
                    t_graph = [timed(solve)[1] for _ in range(GRAPH_RUNS)]
                    row = {"replay_ms": ms_stats(t_graph), "profile": None}
                    log(f"  {key}: replay {fmt_ms(row['replay_ms'])} ms")
                if set(its) != {want}:
                    raise AssertionError(f"{key}: iterations {its}, the "
                                         f"eager loop {want}")
                row["iterations"] = want
                row["masked_steps"] = -want % chunk
                row["replay_ms_per_iteration"] = \
                    row["replay_ms"]["median"] / max(want, 1)
                out[key] = row
                log(f"    {want} iterations under graphs and eager, "
                    f"{row['masked_steps']} masked steps in the last chunk; "
                    f"replay median {row['replay_ms_per_iteration']:.3f} ms "
                    f"an iteration")
    finally:
        pcg.CHUNK = kept


def chebyshev_graphs(dev, out: dict) -> None:
    """Chebyshev(200) with the analytic bounds on phase 12's input, one
    graph against the eager loop, float64 residual under phase 12's
    limit."""
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import chebyshev as ch
    from basic_sparse_matrix_tpu_torch.models.lanczos import LanczosSetup

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    b = torch.randn(n, generator=gen, device=dev)
    setup = LanczosSetup.build(a)

    def check(x):
        res = float(torch.linalg.norm(b.double() - matvec64(a, x))
                    / torch.linalg.norm(b.double()))
        log(f"    float64 residual {res:.3e} (limit {CHEBY_RES_MAX:g})")
        if not res <= CHEBY_RES_MAX:
            raise AssertionError("graphed Chebyshev: residual over the "
                                 "limit")
    key = "Chebyshev(200), analytic bounds"
    out[key] = graph_vs_eager(
        key, lambda: ch.chebyshev_solve(a, b, iters=200,
                                        bounds=(LAMBDA_MIN, LAMBDA_MAX),
                                        setup=setup)[0], check)


def compiled_loops_phase(dev, solver6, tree, batched_operands) -> dict:
    """Phase 22: every graphed loop of PR 11's slice against its eager loop
    on the same card in the same run. Each row keeps under ``profile`` the
    call that :func:`profile_rows` profiles after phase 23 (device
    operations = the launches its graphs hold, busy share), with one eager
    supernodal solve beside them."""
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import pcg

    log(f"compiled loops (phase 22): captured CUDA graphs against the eager "
        f"loops; pcg.CHUNK = {pcg.CHUNK}:")
    out = {}
    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    x_true, b8 = seeded_system(a, SEED + 3)
    t0 = time.perf_counter()
    fwd, bwd = direct_graphs(f"supernodal {SOLVER_K}³ ND solve", solver6, a,
                             x_true, b8, out)
    # the batched 8 × 8 solves of 21(a), on the solver's unknowns, on the
    # same fresh schedule copies
    ops = batched_operands
    pair = triangular_pair(fwd, bwd, (ops["vf"], ops["vb"]))

    def check_batch(x):
        for i in range(x.shape[0]):
            check_solution(f"system {i}", ops["mats"][i], x[i],
                           ops["x_true"][i], ops["rhs"][i])
    key = f"batched {BATCH} systems × 8 rhs"
    out[key] = graph_vs_eager(key, lambda: pair(ops["rhs"]), check_batch)
    log(f"  [supernodal: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    tree_solver, tree_a = tree
    tx, tb = seeded_system(tree_a, SEED + 6)
    direct_graphs(f"tree scatter solve (n {tree_a.rows})", tree_solver,
                  tree_a, tx, tb, out)
    log(f"  [tree: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    pcg_graphs(dev, out)
    log(f"  [PCG: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    chebyshev_graphs(dev, out)
    log(f"  [Chebyshev: {time.perf_counter() - t0:.1f} s]")

    eager_key = f"supernodal {SOLVER_K}³ ND solve 1 rhs"
    out["eager " + eager_key] = {"profile": eagerly(out[eager_key]["profile"])}
    return out


# torch.profiler loses device events now and then in long windows (a Bt 8
# replay of ≈ 62,000 events once showed 1,536 of its 1,542 K3 launches): a
# lost event only lowers a count, so a row whose kernels are checked is
# profiled again, up to this many times, while a count falls short.
PROFILE_TRIES = 3


def profile_rows(phase: str, out: dict, want=None) -> None:
    """One profiled call of each row's ``profile`` function (a replay, or
    an eager call), in place: device operations, the ported kernels by
    name, device busy share. A row named in ``want`` (kernel counts it must
    hold) is profiled again while a count falls short, its counts the
    largest seen (``profiles`` = the calls profiled). Last in the run:
    after a profiled window, unprofiled walls of launch-bound loops in the
    same process read slow."""
    t0 = time.perf_counter()
    for key, row in out.items():
        fn = row.pop("profile", None)
        if fn is None:
            continue
        row.update(device_busy(fn))
        need = (want or {}).get(key, {})
        row["profiles"] = 1
        while row["profiles"] < PROFILE_TRIES and any(
                row["kernels"][k] < n for k, n in need.items()):
            again = device_busy(fn)["kernels"]
            row["kernels"] = {k: max(v, again[k])
                              for k, v in row["kernels"].items()}
            row["profiles"] += 1
        log(f"  {phase} {key}: one call profiled: {row['device_ops']} device "
            f"operations (K3 {row['kernels']['runs_read']}, rect entry "
            f"{row['kernels']['addback_rects']}, K2 "
            f"{row['kernels']['spmm_stream']}; library kernels by name "
            f"{row['library']}), device busy "
            f"{100 * row['busy_share']:.1f}% of the "
            f"{row['profiled_ms']:.2f} ms window; kernels the largest of "
            f"{row['profiles']} profiled calls "
            f"[{time.perf_counter() - t0:.1f} s]")
    log(f"  [{phase} profiles: {time.perf_counter() - t0:.1f} s]")


# ---- the compiled programs (phase 23) --------------------------------------
PROGRAM_BATCH_TREE = 4          # (b): 21(b)'s batch
LANCZOS_K = 32                  # (c)
RITZ_REPLAY_REL = 1e-4          # (c): replayed Ritz values vs eager, of |λ|
QR_K = 8                        # (e): the densified 8³ Laplacian, n = 512
QR_ITERATIONS = 200


def factor_graphs(label: str, sched, factorize, ap, values, solver, orders,
                  x_true, out: dict) -> None:
    """A numeric phase re-run on new values of ``ap``'s pattern (``values``
    (nnz,) or (Bt, nnz)) on ``sched`` (a fresh owner: the first call runs
    eagerly, the second captures), the replays against the eager loop; the
    replayed factors' solves (the solver's batched triangular solves on
    8 rhs a system) under phase 6's limits."""
    batch = values if values.ndim == 2 else values[None]

    def check(lv):
        lv = lv if lv.ndim == 2 else lv[None]
        vf, vb = batched_solve_values(solver, lv, orders)
        mats = [with_values(ap, v) for v in batch]
        rhs = torch.stack([matvec64(m, x_true).float() for m in mats])
        x = batched_solves(solver, orders[2], vf, vb, rhs)
        for b in range(len(mats)):
            check_solution(f"{label}, system {b}: replayed factor's solve, "
                           f"8 rhs", mats[b], x[b], x_true, rhs[b])
    out[label] = graph_vs_eager(label, lambda: factorize(sched, values),
                                check, capture_on=2)


def programs_check_kernels(out: dict, profiled: dict) -> None:
    """Each profiled replay held the ported kernels' launches of its eager
    call (``profiled[label]``: launches by ``KERNEL_NAMES`` key)."""
    for label, want in profiled.items():
        got = {k: out[label]["kernels"][k] for k in want}
        log(f"  {label}: a replay holds {got} (by kernel name); the eager "
            f"loop launched {want}")
        if got != want:
            raise AssertionError(f"{label}: a replay holds {got}, the eager "
                                 f"loop launched {want}")


def lanczos_graphs(dev, out: dict) -> None:
    """Lanczos(32) on phase 12's 33³ Laplacian through a fresh operator's
    set-up, two seeded start vectors: Ritz values of each replay within
    ``RITZ_REPLAY_REL·|λ|`` of the eager run."""
    from basic_sparse_matrix_tpu_torch import CSR, SparseOperator
    from basic_sparse_matrix_tpu_torch.models.lanczos import _ritz_values

    n, r, c, v = laplacian_3d(SOLVER_K)
    setup = SparseOperator(CSR.from_coo_arrays((n, n), r, c, v,
                                               device=dev))._ensure_lanczos()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    v0s = [torch.randn(n, generator=gen, device=dev) for _ in range(2)]

    def ritz(v0):
        return lambda: _ritz_values(setup, v0, LANCZOS_K)

    def check_of(v0):
        def check(got):
            want = eagerly(ritz(v0))()
            err = float(((got - want).abs() / want.abs()).max())
            log(f"    Ritz values, replay vs eager: {err:.3e} of |λ| (limit "
                f"{RITZ_REPLAY_REL:g})")
            if not err <= RITZ_REPLAY_REL:
                raise AssertionError("Lanczos replay: Ritz values off")
        return check
    key = f"Lanczos({LANCZOS_K}), {SOLVER_K}³"
    out[key] = graph_vs_eager(key, ritz(v0s[0]), check_of(v0s[0]),
                              capture_on=2)
    check_of(v0s[1])(ritz(v0s[1])())


def banded_graphs(dev, out: dict) -> None:
    """The banded scan and BCR solves of phase 10's 33³ RCM matrix on fresh
    solvers (the first solve of a shape captures), at 1 and 8 rhs, under
    phase 6's limits."""
    from basic_sparse_matrix_tpu_torch import CSR, prepare_direct

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v, device=dev)
    x_true, b8 = seeded_system(a, SEED + 4)
    for backend in ("scan", "bcr"):
        use_config(ordering="rcm", banded_solver=backend)
        solver = prepare_direct(a)
        for name, b in (("1 rhs", b8[:, :1].contiguous()), ("8 rhs", b8)):
            key = f"{solver.kind} {SOLVER_K}³ RCM solve {name}"
            out[key] = graph_vs_eager(
                key, lambda b=b, solver=solver: solver.solve(b),
                lambda x, b=b, key=key: check_solution(
                    f"{key} replay", a, x, x_true, b))
    use_config()


def qr_graphs(dev, out: dict) -> None:
    """The QR eigen-iteration, ``QR_ITERATIONS`` steps on the densified 8³
    Laplacian (n = 512): the replay against the eager loop."""
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import qr

    n, r, c, v = laplacian_3d(QR_K)
    d = CSR.from_coo_arrays((n, n), r, c, v, device=dev).todense()

    def check(got):
        if got.shape != (n,) or not bool(torch.isfinite(got).all()):
            raise AssertionError("QR iteration: a non-finite diagonal")
        lam = torch.linalg.eigvalsh(d.double())
        log(f"    diagonal after {QR_ITERATIONS} steps in "
            f"[{float(got.min()):.4f}, {float(got.max()):.4f}] (spectrum "
            f"[{float(lam[0]):.4f}, "
            f"{float(lam[-1]):.4f}])")
    key = f"QR iteration ({QR_ITERATIONS} steps), n {n}"
    out[key] = graph_vs_eager(
        key, lambda: qr.eigen_values_dense(d, QR_ITERATIONS), check,
        capture_on=2)


def compiled_programs_phase(dev, solver6, tree, operands,
                            launches: dict) -> tuple:
    """Phase 23: the numeric phases, Lanczos, the banded and BCR solves and
    the QR iteration as replayed graphs against their eager loops, on the
    smoke's full-size inputs. Returns the rows (each with its ``profile``
    call for :func:`profile_rows`) and, for the supernodal rows, the K3 and
    rect-entry launches a replay must hold: those of 21(a)'s eager
    factorization (``launches``, one system's count at any batch)."""
    import copy

    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    log("compiled programs (phase 23): the numeric phases, Lanczos, the "
        "banded solves and the QR iteration as captured CUDA graphs against "
        "their eager loops:")
    out, profiled = {}, {}
    t0 = time.perf_counter()
    ops = operands["supernodal"]
    sched = copy.copy(solver6.sched)      # a fresh owner: nothing counted
    ap = ops["ap"]
    want = {"runs_read": launches["runs_read"],
            "addback_rects": launches["addback_resident"]}
    for bt in (1, BATCH):
        vals = shifted_values(ap, bt, SEED + 22)
        label = f"supernodal {SOLVER_K}³ ND re-factorization, Bt {bt}"
        factor_graphs(label, sched, sn.factorize_supernodal, ap,
                      vals[0] if bt == 1 else vals, solver6, ops["orders"],
                      ops["x_true"][0], out)
        profiled[label] = want
    log(f"  [(a) supernodal: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    tree_solver, tree_a = tree
    ops = operands["scatter"]
    sched = copy.copy(tree_solver.sched)
    for bt in (1, PROGRAM_BATCH_TREE):
        vals = shifted_values(ops["ap"], bt, SEED + 23)
        factor_graphs(f"tree (n {tree_a.rows}) scatter-list "
                      f"re-factorization, Bt {bt}",
                      sched, sc.factorize, ops["ap"],
                      vals[0] if bt == 1 else vals, tree_solver,
                      ops["orders"], ops["x_true"][0], out)
    log(f"  [(b) scatter-list: {time.perf_counter() - t0:.1f} s]")
    for name, path in (("(c) Lanczos", lanczos_graphs),
                       ("(d) banded", banded_graphs), ("(e) QR", qr_graphs)):
        t0 = time.perf_counter()
        path(dev, out)
        log(f"  [{name}: {time.perf_counter() - t0:.1f} s]")
    return out, profiled


# ---- the distributed compiled programs (phase 24) --------------------------
def sharded_factor_graphs(label: str, factorize, single, out: dict) -> None:
    """A sharded numeric phase on a fresh owner (the first call eager, the
    second captures), the replays against the eager loop and within
    ``DIRECT_FACTOR_ATOL_OF_MAX·max|ref|`` of the single-device factor."""
    out[label] = graph_vs_eager(
        label, factorize,
        lambda lv: close_of_max(f"{label}: replay vs the single-device "
                                f"factor", lv, single,
                                DIRECT_FACTOR_ATOL_OF_MAX), capture_on=2)


def sharded_solve_graphs(label: str, fwd, bwd, a, mesh, seed: int,
                         out: dict, profiled=("1 rhs", "8 rhs")) -> None:
    """The distributed forward + backward solves on fresh copies of a
    solver's schedules (the first call captures) at 1 and 8 rhs, under
    phase 6's limits; the rows named in ``profiled`` keep their replay for
    :func:`profile_rows`."""
    import copy

    fwd, bwd = copy.copy(fwd), copy.copy(bwd)
    x_true, b8 = seeded_system(a, seed)
    for name, b in (("1 rhs", b8[:, :1].contiguous()), ("8 rhs", b8)):
        key = f"{label} {name}"
        out[key] = graph_vs_eager(
            key, lambda b=b: dist_solves(fwd, bwd, b, mesh),
            lambda x, b=b, key=key: check_solution(f"{key} replay", a, x,
                                                   x_true, b))
        out[key]["levels"] = fwd.n_levels + bwd.n_levels
        if name not in profiled:
            del out[key]["profile"]


def sharded_direct_graphs(dev, solver6, tree, operands, out: dict) -> None:
    """24(a), (b): the sharded supernodal (33³ ND) and scatter-list (10⁶
    tree) numeric phases at 4 logical shards on copies of phases 6 and 11's
    schedules, and the distributed solves on their factors."""
    import copy

    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.parallel import cholesky as pc
    from basic_sparse_matrix_tpu_torch.parallel import supernodal as ps
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    mesh = row_mesh(DIRECT_SHARDS, comm="local")
    t0 = time.perf_counter()
    ap = operands["supernodal"]["ap"]
    sched = copy.copy(solver6.sched)
    kept = sum(t.numel() * 8 for g in sn.long_tables(sched) for t in g
               if t.dtype == torch.int64)
    log(f"(a) supernodal, {SOLVER_K}³ ND at {DIRECT_SHARDS} logical shards: "
        f"the int64 tables kept on the schedule (made once, shared by the "
        f"single-device and sharded phases) hold {kept / 2**20:.2f} MiB")
    single = eagerly(lambda: sn.factorize_supernodal(sched, ap.values))()
    sharded_factor_graphs(
        f"sharded supernodal {SOLVER_K}³ ND numeric, {DIRECT_SHARDS} shards",
        lambda sched=sched, ap=ap: ps.factorize_supernodal_sharded(
            sched, ap.values, mesh), single, out)
    del single
    # the 8-rhs replay holds the 1-rhs one's launches; profiling a replay
    # of 114,000 launches takes 12 s
    sharded_solve_graphs(f"distributed solve, {SOLVER_K}³ ND supernodal "
                         f"factor, {DIRECT_SHARDS} shards,", solver6._fwd,
                         solver6._bwd, ap, mesh, SEED + 24, out,
                         profiled=("1 rhs",))
    log(f"  [(a) supernodal: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    tree_solver, tree_a = tree
    ap = operands["scatter"]["ap"]
    sched = copy.copy(tree_solver.sched)
    single = eagerly(lambda: sc.factorize(sched, ap.values))()
    sharded_factor_graphs(
        f"sharded scatter-list tree (n {tree_a.rows}) numeric, "
        f"{DIRECT_SHARDS} shards",
        lambda sched=sched, ap=ap: pc.factorize_sharded(sched, ap.values,
                                                        mesh), single, out)
    sharded_solve_graphs(f"distributed solve, tree (n {tree_a.rows}) "
                         f"factor, {DIRECT_SHARDS} shards,", tree_solver._fwd,
                         tree_solver._bwd, ap, mesh, SEED + 25, out)
    log(f"  [(b) scatter-list: {time.perf_counter() - t0:.1f} s]")


def sharded_solver_graphs(dev, out: dict) -> None:
    """24(c): ``DistributedOperator`` on the 33³ Laplacian at 8 logical
    shards (phase 19(b)'s input): CG, PCG and Chebyshev replays under
    phase 19's residual limits, Chebyshev with new bounds on its graph, and
    Lanczos(32) (Ritz values of the replay within ``RITZ_REPLAY_REL·|λ|``
    of the eager run's)."""
    import torch.nn.functional as F

    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.parallel import chebyshev as pch
    from basic_sparse_matrix_tpu_torch.parallel import lanczos as pl
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh
    from basic_sparse_matrix_tpu_torch.parallel.operator import (
        DistributedOperator)
    from basic_sparse_matrix_tpu_torch.runtime import graphs

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    op = DistributedOperator(a, row_mesh(PAR_SERVING_SHARDS, comm="local"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    rhs = torch.randn(n, generator=gen, device=dev)
    eagerly(op._ensure_block_jacobi)()
    # the Chebyshev bounds from the operator's own Lanczos, eagerly
    eagerly(lambda: op.solve_chebyshev(rhs, iters=1))()
    log(f"(c) DistributedOperator, {SOLVER_K}³ Laplacian at "
        f"{PAR_SERVING_SHARDS} logical shards; Chebyshev bounds "
        f"{op._bounds[0]:.6f}, {op._bounds[1]:.6f}")

    def residual(name, limit):
        def check(x):
            res = float(torch.linalg.norm(rhs.double() - matvec64(a, x))
                        / torch.linalg.norm(rhs.double()))
            log(f"    {name}: float64 relative residual {res:.3e} (limit "
                f"{limit:g})")
            if not res <= limit:
                raise AssertionError(f"{name}: residual over the limit")
        return check
    for name, call, iters, limit in (
            ("solve_cg", op.solve_cg, PAR_CG_ITERS, PAR_RES_MAX),
            ("solve_pcg", op.solve_pcg, PAR_PCG_ITERS, PAR_RES_MAX),
            ("solve_chebyshev", op.solve_chebyshev, PAR_CHEB_ITERS,
             PAR_CHEB_RES_MAX)):
        key = f"sharded {name} ({iters} iterations), {PAR_SERVING_SHARDS} " \
              f"shards"
        out[key] = graph_vs_eager(
            key, lambda call=call, iters=iters: call(rhs, iters=iters),
            residual(key, limit))
        out[key]["iterations"] = iters
        out[key]["replay_ms_per_iteration"] = \
            out[key]["replay_ms"]["median"] / iters
        out[key]["eager_ms_per_iteration"] = \
            out[key]["eager_ms"]["median"] / iters
        log(f"    per iteration: eager "
            f"{out[key]['eager_ms_per_iteration']:.3f} ms, replay "
            f"{out[key]['replay_ms_per_iteration']:.3f} ms")
    out["eager sharded solve_cg"] = {
        "profile": eagerly(lambda: op.solve_cg(rhs, iters=PAR_CG_ITERS))}
    # new bounds replay the Chebyshev graph: no new key
    held = graphs.count(op.sa)
    bounds = (0.9 * op._bounds[0], 1.02 * op._bounds[1])

    def other(bounds=bounds):
        return pch.chebyshev_solve_sharded(op.sa, rhs, op.mesh,
                                           iters=PAR_CHEB_ITERS,
                                           bounds=bounds, n=n)[0]
    x = other()
    if graphs.count(op.sa) != held:
        raise AssertionError("new Chebyshev bounds made a new graph")
    close_of_max("sharded Chebyshev, new bounds: replay vs eager loop", x,
                 eagerly(other)(), GRAPH_ATOL_OF_MAX)
    v0 = F.pad(torch.randn(n, generator=gen, device=dev),
               (0, op.sa.padded_rows - n))
    key = f"sharded Lanczos({LANCZOS_K}), {PAR_SERVING_SHARDS} shards"

    def ritz():
        return pl.ritz_values(*pl.lanczos_sharded_from(op.sa, v0, LANCZOS_K,
                                                       op.mesh, n=n))

    def check_ritz(got):
        want = eagerly(ritz)()
        err = float(((got - want).abs() / want.abs()).max())
        log(f"    Ritz values, replay vs eager: {err:.3e} of |λ| (limit "
            f"{RITZ_REPLAY_REL:g})")
        if not err <= RITZ_REPLAY_REL:
            raise AssertionError("sharded Lanczos replay: Ritz values off")
    out[key] = graph_vs_eager(key, ritz, check_ritz, capture_on=2)
    log(f"  graphs on the ShardedCSR: {graphs.count(op.sa)} (of "
        f"{graphs.MAX_GRAPHS_PER_OWNER} kept an owner)")


def sharded_bcr_graphs(dev, out: dict) -> None:
    """24(d): ``bcr_solve_sharded`` on the 33³ RCM Laplacian's blocks,
    padded to 4·2^q block rows once on the host, at 1 and 8 rhs under phase
    6's limits (the first call eager, the second captures)."""
    import torch.nn.functional as F

    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.ops.csr import to_tensor
    from basic_sparse_matrix_tpu_torch.ops.reorder import (
        permute_symmetric, rcm_permutation)
    from basic_sparse_matrix_tpu_torch.parallel import bcr as pb
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh

    n, r, c, v = laplacian_3d(SOLVER_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    ap = permute_symmetric(a, rcm_permutation(a))
    D, E = pb.padded_band_blocks(ap, DIRECT_SHARDS)
    mp, nb = D.shape[0], D.shape[1]
    D, E = to_tensor(D, dev), to_tensor(E, dev)
    mesh = row_mesh(DIRECT_SHARDS, comm="local")
    log(f"(d) bcr_solve_sharded, {SOLVER_K}³ Laplacian under RCM: nb {nb}, "
        f"{mp} block rows at {DIRECT_SHARDS} shards, D and E "
        f"{2 * D.numel() * 4 / 2**20:.1f} MiB")
    x_true, b8 = seeded_system(ap, SEED + 26)
    for name, b in (("1 rhs", b8[:, :1].contiguous()), ("8 rhs", b8)):
        bb = F.pad(b, (0, 0, 0, mp * nb - n)).reshape(mp, nb, b.shape[1])
        key = f"sharded BCR {SOLVER_K}³ RCM solve {name}, {DIRECT_SHARDS} " \
              f"shards"
        out[key] = graph_vs_eager(
            key, lambda bb=bb: pb.bcr_solve_sharded(D, E, bb, mesh),
            lambda x, b=b, key=key: check_solution(
                f"{key} replay", ap, x.reshape(mp * nb, -1)[:n], x_true, b),
            capture_on=2)


def sharded_nccl_graphs(dev) -> None:
    """24(e): at world size 1 over NCCL every compiled program of
    ``parallel/`` (the first call eager where it captures on the second,
    then the capture, then a replay) against the same call on eager
    ``LocalComm`` at one shard, bit for bit under deterministic algorithms
    (the supernodal factor, whose add-back adds with atomics, within
    ``NCCL_ATOL_OF_MAX·max|ref|``), on the 14³ Laplacian; the graphs are
    kept by the communicator and go with it."""
    import weakref

    import torch.distributed as dist

    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc
    from basic_sparse_matrix_tpu_torch.models import sparse_triangular as st
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn
    from basic_sparse_matrix_tpu_torch.ops.csr import to_tensor
    from basic_sparse_matrix_tpu_torch.ops.reorder import (
        nd_permutation, permute_symmetric)
    from basic_sparse_matrix_tpu_torch.parallel import bcr as pb
    from basic_sparse_matrix_tpu_torch.parallel import cg as pcg
    from basic_sparse_matrix_tpu_torch.parallel import chebyshev as pch
    from basic_sparse_matrix_tpu_torch.parallel import cholesky as pc
    from basic_sparse_matrix_tpu_torch.parallel import lanczos as pl
    from basic_sparse_matrix_tpu_torch.parallel import pcg as ppcg
    from basic_sparse_matrix_tpu_torch.parallel import sharded as sh
    from basic_sparse_matrix_tpu_torch.parallel import supernodal as ps
    from basic_sparse_matrix_tpu_torch.parallel import triangular as pt
    from basic_sparse_matrix_tpu_torch.parallel.mesh import row_mesh
    from basic_sparse_matrix_tpu_torch.runtime import graphs

    n, r, c, v = laplacian_3d(FORMULATION_K)
    a = CSR.from_coo_arrays((n, n), r, c, v)
    ap = permute_symmetric(a, nd_permutation(a))
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    b8 = torch.randn((n, 8), generator=gen, device=dev)
    nccl_up()
    mesh_d, mesh_l = row_mesh(comm="dist"), row_mesh(1, comm="local")
    comm = mesh_d.axis("rows")
    log(f"(e) NCCL at world size 1, {FORMULATION_K}³ Laplacian (n {n}): "
        f"communicator key "
        f"{comm.graph_key[:4]}, capturable {comm.capturable}; graphed "
        f"TorchDistComm against eager LocalComm at one shard, deterministic "
        f"algorithms on:")
    if not comm.capturable:
        raise AssertionError("an NCCL TorchDistComm is not capturable")
    chol = sc.analyze(ap)
    fwd = st.build_schedule(sc.cholesky_sparse(ap))
    snode = sn.analyze_supernodal(ap)
    sa = sh.put_sharded(sh.shard_csr(a, 1), mesh_l)
    lfac = eagerly(lambda: ppcg.build_block_jacobi(sa, mesh_l))()
    D, E = (to_tensor(t, dev) for t in pb.padded_band_blocks(
        a, 1, FORMULATION_K ** 2))
    bb = torch.nn.functional.pad(b8, (0, 0, 0, D.shape[0] * D.shape[1] - n)
                                 ).reshape(D.shape[0], D.shape[1], 8)
    v0 = torch.randn(sa.padded_rows, generator=gen, device=dev)
    programs = (
        ("factorize_sharded", chol, 2,
         lambda m: pc.factorize_sharded(chol, ap.values, m)),
        ("solve_triangular_sharded", fwd, 1,
         lambda m: pt.solve_triangular_sharded(fwd, b8, m)),
        ("factorize_supernodal_sharded", snode, 2,
         lambda m: ps.factorize_supernodal_sharded(snode, ap.values, m)),
        ("cg_solve_sharded", sa, 1,
         lambda m: pcg.cg_solve_sharded(sa, b8[:, 0], m, iters=30)),
        ("pcg_solve_sharded", sa, 1,
         lambda m: ppcg.pcg_solve_sharded(sa, b8[:, 0], m, iters=20,
                                          lfac=lfac)),
        ("chebyshev_solve_sharded", sa, 1,
         lambda m: pch.chebyshev_solve_sharded(
             sa, b8[:, 0], m, iters=40, bounds=(0.1, 12.0))[0]),
        ("lanczos_sharded_from", sa, 2,
         lambda m: torch.cat(pl.lanczos_sharded_from(sa, v0, 16, m))),
        ("bcr_solve_sharded", pb._BCR_SHARDED, 2,
         lambda m: pb.bcr_solve_sharded(D, E, bb, m)))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, owner, capture_on, call in programs:
            holder = comm.graph_owner(owner)
            held = graphs.count(holder)
            outs = [call(mesh_d) for _ in range(capture_on + 1)]
            if graphs.count(holder) != held + 1:
                raise AssertionError(f"{name}: {graphs.count(holder) - held} "
                                     f"graphs captured on the communicator's "
                                     f"holder, not 1")
            want = eagerly(lambda: call(mesh_l))()
            for i in range(capture_on - 1, capture_on + 1):
                what = ("capture" if i == capture_on - 1 else "replay")
                if owner is snode:
                    close_of_max(f"{name} over NCCL, {what} (the add-back's "
                                 f"atomicAdd)", outs[i], want,
                                 NCCL_ATOL_OF_MAX)
                else:
                    same_bits(f"{name} over NCCL, {what}", outs[i], want)
    finally:
        torch.use_deterministic_algorithms(False)
    alive = weakref.ref(holder)
    del holder, comm, mesh_d, outs
    gc.collect()
    if alive() is not None:
        raise AssertionError("the NCCL graphs outlived their communicator")
    dist.destroy_process_group()
    log("  the graphs went with the communicator; process group destroyed")


def sharded_programs_phase(dev, solver6, tree, operands, ring) -> dict:
    """Phase 24: every compiled program of ``parallel/`` as a replayed CUDA
    graph against the same call under ``eager_loops()``, on the inputs of
    phases 19(b) and 20(a)-(c) (phases 6 and 11's solvers), NCCL at world
    size 1, and (f) the rings on phase 19's operand kept for it, eagerly
    and as graphs made here (the port keeps them op by op). Returns the
    rows, each with its ``profile`` call."""
    log("distributed compiled programs (phase 24): parallel/'s loops as "
        "captured CUDA graphs against their eager loops:")
    out = {}
    sharded_direct_graphs(dev, solver6, tree, operands, out)
    for name, part in (("(c) solvers", sharded_solver_graphs),
                       ("(d) BCR", sharded_bcr_graphs)):
        t0 = time.perf_counter()
        part(dev, out)
        torch.cuda.empty_cache()
        log(f"  [{name}: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    sharded_nccl_graphs(dev)
    log(f"  [(e) NCCL: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    ring_graphs(ring, out)
    log(f"  [(f) rings: {time.perf_counter() - t0:.1f} s]")
    return out


class _RingGraphs:
    """The owner of 24(f)'s graphs of the rings (the port runs them op by
    op)."""


def ring_graphs(ring, out: dict) -> None:
    """24(f): ``spmm_ring`` at 4 shards and ``spmm_ring_2d`` at 2 × 2 on
    phase 19's 1M × 1M × 32 operand and B, eagerly as the port runs them,
    against a CUDA graph of the same call made here through ``graphs.run``
    (the first call eager, the second captures): the measurement behind
    keeping the rings op by op (the graph copies B in and clones the
    result). Both eager rings are profiled beside the graphs."""
    from basic_sparse_matrix_tpu_torch.parallel import spmm as psp
    from basic_sparse_matrix_tpu_torch.parallel import spmm2d
    from basic_sparse_matrix_tpu_torch.runtime import graphs

    sa, sa2, b_st, mesh, mesh2 = ring
    s = mesh.shape["rows"]
    shape = f"1M × 1M × 32 × {b_st.shape[1]}"
    owner = _RingGraphs()
    for key, call in (
            (f"spmm_ring, {shape}, {s} shards",
             lambda b: psp.spmm_ring(sa, b, mesh)),
            (f"spmm_ring_2d, {shape}, 2 × 2",
             lambda b: spmm2d.spmm_ring_2d(sa2, b, mesh2))):
        out[f"graph of {key}"] = graph_vs_eager(
            f"graph of {key}",
            lambda call=call, key=key: graphs.run(owner, key, call, b_st,
                                                  capture_on=2),
            lambda y, key=key: on_card(key, y),
            eager=lambda call=call: call(b_st), capture_on=2)
        out[f"eager {key}"] = {"profile": lambda call=call: call(b_st)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is False); nothing was run")
    from basic_sparse_matrix_tpu_torch import mul_dense
    from basic_sparse_matrix_tpu_torch.ops import ell as ell_mod
    from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as k1
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as k2
    from basic_sparse_matrix_tpu_torch.runtime import cuda_kernels

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
            f"density {a.get_density():.3e}, on {a.device} (no device named: "
            f"the configured default)")
        if a.device.type != "cuda":
            raise AssertionError(f"{name}: a constructor with no device "
                                 f"argument built on {a.device}")

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
    for bm in (64, 256, 8):
        log(f"  spmm_bsr launch config for bm {bm}: "
            f"{k1.kernel_config(bm)}")
    err, ms, plain_ms = k1_vs_plain(bsr, b_bsr, "(64, 256) rung", 10)

    def bsr_library():
        t = live_blocks_csr(bsr)
        return lambda: torch.sparse.mm(t, b_bsr)
    lib_ms = library_time("torch.sparse.mm(sparse_csr_tensor of the live "
                          "(64, 256) blocks, B; the conversion untimed)",
                          bsr_library, k1.spmm_bsr(bsr, b_bsr), 10)
    n_out = int(b_bsr.shape[1])
    # the live blocks, B and the index lists read once, C written once;
    # 2·bm·bk·N operations per live block
    kernels = [{"name": "spmm_bsr", "route": "cuda",
                "source": "basic_sparse_matrix_tpu_torch/csrc/spmm_bsr.cu",
                "replaces": "basic_sparse_matrix_tpu/ops/pallas/"
                            "spmm_kernel.py:178",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                **bound(4 * (bsr.n_live * bsr.bm * bsr.bk
                             + 2 * bsr.n_live + 2 * bsr.n_block_rows
                             + b_bsr.numel() + bsr.rows * n_out),
                        2.0 * bsr.bm * bsr.bk * n_out * bsr.n_live),
                "library_ms": lib_ms}]
    # The other two pick_tiles shapes, each > 100 MB of blocks and a B
    # larger than the 50 MB L2.
    for n, bm, bk, nblocks in ((32768, 256, 512, 410),
                               (65536, 8, 128, 25600)):
        t0 = time.perf_counter()
        other, b_other = random_bsr(rng, dev, gen, n, bm, bk, nblocks)
        torch.cuda.synchronize()
        log(f"  ({bm}, {bk}) operand {n}x{n} built on the host through "
            f"make_bsr: {time.perf_counter() - t0:.2f} s")
        k1_vs_plain(other, b_other, f"({bm}, {bk})", 10)
        del other, b_other
        torch.cuda.empty_cache()

    k2_entry, k2_ns_per_entry = stream_kernels_vs_plain(plan, a_st, b_st)
    kernels.append(k2_entry)

    # ---- 4. main path through mul_dense ---------------------------------
    log("main path (mul_dense, twice per rung: the first call includes "
        "one-time host work such as densifying or the BSR fill count):")
    checks = []
    zero_launches()
    for name, a, b, want in (("dense", a_dense, b_dense, (0, 0)),
                             ("bsr", a_bsr, b_bsr, (2, 0)),
                             ("stream", a_st, b_st, (0, 2))):
        before = (k1.LAUNCHES, k2.LAUNCHES)
        sliced_before = k2.LAUNCHES_BY_KERNEL["sliced"]
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
        if name == "stream" and k2.LAUNCHES_BY_KERNEL["sliced"] \
                != sliced_before + 2:
            raise AssertionError("the stream rung did not launch the sliced "
                                 "K2 kernel twice")
        checks.append((name, a, b, out))
    ref_st = out    # the stream rung's product, phase 19's reference
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
    out = mul_dense(CSR.from_dense(d), torch.as_tensor(bs, device=dev))
    compare("small mul_dense vs numpy float64",
            out, torch.as_tensor(d.astype(np.float64) @ bs,
                                 device=dev).float())
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # ---- 19. parallel/, while the 1M-row operand is resident ---------------
    t0 = time.perf_counter()
    _, ring = parallel_phase(dev, a_st, b_st, ref_st)
    torch.cuda.empty_cache()
    log(f"  [parallel_phase: {time.perf_counter() - t0:.1f} s]")
    # ---- 21(c). a batch of right-hand sides, while the operand is resident
    t0 = time.perf_counter()
    batched_rhs = batched_rhs_spmm(a_st, dev)
    torch.cuda.empty_cache()
    log(f"  [batched_rhs_spmm: {time.perf_counter() - t0:.1f} s]")
    # the rung loops leave a and b bound to the 1M-row operand (≈ 2.8 GiB);
    # ring keeps its 4 shards and b_st for phase 24(f)'s profile, last
    del a_dense, b_dense, a_bsr, b_bsr, a_st, b_st, bsr, plan, a, b, ref_st
    torch.cuda.empty_cache()

    # ---- 6. solver main path ------------------------------------------
    main = solver_main_path(dev)

    # ---- 7. K3-K5 kernel vs plain at the solver's shapes -----------------
    log("solver kernels vs plain on the card:")
    # On the card the main path reaches the add-back kernel through its rect
    # entry only, by addback_rects on every routed level: the K4 row carries
    # addback_resident's count (every rect launch), the K5 row panel_addback's
    # (its span wrapper, which the main path never calls: 0).
    for k in solver_kernels_vs_plain(main["solver"], gen):
        kernels.append({"route": "cuda",
                        "launches": main["launches"][k["name"]], **k})
    solver6 = main["solver"]    # phase 21(a) factors on its schedule
    k7_launches = main["launches"]["trsv_level"]
    del main

    # ---- 8. per-formulation factors, card vs CPU ------------------------
    log(f"per-formulation factors at k={FORMULATION_K}:")
    formulations_on_card(dev)
    torch.cuda.empty_cache()

    # ---- 9-13. the rest of models/; 14-17. the sparse × sparse path and
    # the file round trips -----------------------------------------------
    returned = {}
    for phase in (serving_path, banded_tiers, scatter_tier, iterative_path,
                  card_vs_cpu_k14, ss_add_path, ss_mul_dense_path,
                  ss_mul_planned_path, matmul_sparse_path):
        t0 = time.perf_counter()
        returned[phase.__name__] = phase(dev)
        torch.cuda.empty_cache()
        log(f"  [{phase.__name__}: {time.perf_counter() - t0:.1f} s]")

    # ---- 18. K6 and its probe -----------------------------------------------
    t0 = time.perf_counter()
    kernels.append(k6_phase(dev, k2_ns_per_entry))
    log(f"  [k6_phase: {time.perf_counter() - t0:.1f} s]")

    # ---- 25. K7 at the benchmark's shapes ----------------------------------
    t0 = time.perf_counter()
    kernels.append(k7_phase(dev, k7_launches))
    torch.cuda.empty_cache()
    log(f"  [k7_phase: {time.perf_counter() - t0:.1f} s]")

    # ---- 20. parallel/: the distributed direct solvers and BCR -----------
    t0 = time.perf_counter()
    direct_launches = direct_parallel_phase(dev)
    torch.cuda.empty_cache()
    log(f"  [direct_parallel_phase: {time.perf_counter() - t0:.1f} s]")
    # K3 and the add-back's wrappers as the sharded supernodal
    # factorization of 20(a) launched them (every rect launch on the K4 row)
    for k in kernels:
        if k["name"] in ("runs_read", "addback_resident", "panel_addback"):
            k["launches_parallel"] = direct_launches[k["name"]]

    # ---- 21. batched values ----------------------------------------------
    t0 = time.perf_counter()
    batched = batched_values_phase(dev, solver6, returned["scatter_tier"],
                                   gen)
    torch.cuda.empty_cache()
    log(f"  [batched_values_phase: {time.perf_counter() - t0:.1f} s]")
    # K3 and the rect entry with a batch axis; launches are those of 21(a)'s
    # batched factorization (one system's count)
    launches21 = batched["supernodal"]["launches"]
    check_rects("the batched factorization", launches21,
                rect_levels(solver6.sched))
    for k in kernels:
        if k["name"] in batched["kernels"]:
            k["batched"] = {**batched["kernels"][k["name"]],
                            "launches": launches21[k["name"]]}
    batched.pop("kernels")
    batched["spmm_rhs"] = batched_rhs
    operands = {k: batched[k].pop("operands")
                for k in ("supernodal", "scatter")}
    log("phase 21 summary: " + json.dumps(batched, default=float))

    # ---- 22. the compiled loops --------------------------------------------
    t0 = time.perf_counter()
    loops = compiled_loops_phase(dev, solver6, returned["scatter_tier"],
                                 operands["supernodal"])
    log(f"  [compiled_loops_phase: {time.perf_counter() - t0:.1f} s]")

    # ---- 23. the compiled programs -----------------------------------------
    t0 = time.perf_counter()
    programs, profiled = compiled_programs_phase(
        dev, solver6, returned["scatter_tier"], operands,
        batched["supernodal"]["launches"])
    log(f"  [compiled_programs_phase: {time.perf_counter() - t0:.1f} s]")

    # ---- 24. the distributed compiled programs -----------------------------
    t0 = time.perf_counter()
    sharded = sharded_programs_phase(dev, solver6, returned["scatter_tier"],
                                     operands, ring)
    log(f"  [sharded_programs_phase: {time.perf_counter() - t0:.1f} s]")
    # a sharded supernodal replay holds the K3 and rect-entry launches of
    # 20(a)'s eager sharded factorization (same pattern, ranks, config)
    label24 = (f"sharded supernodal {SOLVER_K}³ ND numeric, {DIRECT_SHARDS} "
               f"shards")
    profiled24 = {label24: {
        "runs_read": direct_launches["runs_read"],
        "addback_rects": direct_launches["addback_resident"]}}
    # the profiled calls of phases 22 to 24, last
    t0 = time.perf_counter()
    profile_rows("phase 22", loops)
    profile_rows("phase 23", programs, profiled)
    profile_rows("phase 24", sharded, profiled24)
    programs_check_kernels(programs, profiled)
    programs_check_kernels(sharded, profiled24)
    del solver6, returned, operands, ring
    torch.cuda.empty_cache()
    log(f"  [profiles: {time.perf_counter() - t0:.1f} s]")
    log("phase 22 summary: " + json.dumps(loops, default=float))
    log("phase 23 summary: " + json.dumps(programs, default=float))
    log("phase 24 summary: " + json.dumps(sharded, default=float))
    # K3 and the rect entry (the K4 row) as a replay of 24(a)'s sharded
    # numeric phase holds them, by kernel name
    for k in kernels:
        if k["name"] in ("runs_read", "addback_resident"):
            k["launches_parallel_replay"] = sharded[label24]["kernels"][
                "runs_read" if k["name"] == "runs_read" else "addback_rects"]
    # every kernel row but K5's was launched by its main path; K5's span
    # wrapper is off the main path (its launches were checked to be 0)
    for k in kernels:
        if (k["launches"] < 1) != (k["name"] == "panel_addback"):
            raise AssertionError(f"{k['name']}: {k['launches']} launches on "
                                 f"its main path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
