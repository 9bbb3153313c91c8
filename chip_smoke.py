#!/usr/bin/env python3
"""Drive the PyTorch port's CSR × dense SpMM main path once on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA GPU and nvcc):

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. Device: the card's name and ``nvidia-smi``'s name and power limit.
2. Build: the K1 (BSR) and K2 (streaming) kernels from
   ``basic_sparse_matrix_tpu_torch/csrc`` with nvcc, timed.
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

Tolerance on the card: float32 summed in another order than the plain
version, so ``|out - ref| <= 1e-4 * |ref| + 1e-4 * max|ref|``.

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
    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
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
    launches = (k1.LAUNCHES, k2.LAUNCHES)
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

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
