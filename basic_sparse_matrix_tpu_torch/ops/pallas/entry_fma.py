"""Per-entry fused multiply-add into an output tile: the K6 CUDA kernel and
its plain version.

Counterpart of the kernel in ``benchmarks/entry_fma_probe.py`` (``build``),
the cost probe of the streaming SpMM's inner step. :func:`entry_fma`
computes ``C = 0; for e: C[ii[e], :] += vv[e] * B[kk[e], :]`` with ``B`` and
``C`` of shape (rows, lanes), entries that name one output row summed:

* on CUDA tensors with the hand-written kernel ``csrc/entry_fma.cu`` (C in
  global memory, resident in L2; one thread per entry and four lanes;
  atomic adds, since output rows repeat), or it raises;
* on CPU tensors with :func:`entry_fma_reference`, an ``index_add_``.

The kernel adds in no fixed order, so its float32 sums differ from the
plain version's in the last bits. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

# Launches of the K6 CUDA kernel in this process (a plain counter that a
# caller may reset to 0).
LAUNCHES = 0


def _check(ii, kk, vv, b, rows: int, check_range: bool = True) -> None:
    if ii.ndim != 1 or ii.shape != kk.shape or ii.shape != vv.shape \
            or b.ndim != 2 or b.shape[0] != rows:
        raise ValueError(f"entry_fma takes ii, kk, vv (E,) and b (rows, "
                         f"lanes) with rows = {rows}, got "
                         f"{tuple(ii.shape)}, {tuple(kk.shape)}, "
                         f"{tuple(vv.shape)}, {tuple(b.shape)}")
    if ii.dtype != torch.int32 or kk.dtype != torch.int32 \
            or vv.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"entry_fma takes int32 ii and kk and float32 vv "
                        f"and b, got {ii.dtype}, {kk.dtype}, {vv.dtype}, "
                        f"{b.dtype}")
    if not (ii.device == kk.device == vv.device == b.device):
        raise ValueError("ii, kk, vv and b must share one device")
    if check_range and ii.numel():
        lo, hi = torch.aminmax(torch.stack([ii, kk]))
        if int(lo) < 0 or int(hi) >= rows:
            raise IndexError(f"entry_fma indices outside [0, {rows})")


def entry_fma_reference(ii: torch.Tensor, kk: torch.Tensor,
                        vv: torch.Tensor, b: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Plain PyTorch version of K6: every entry's product ``v * B[k]``
    added into row ``i`` with ``index_add_``. Returns (rows, lanes)
    float32."""
    _check(ii, kk, vv, b, rows)
    out = torch.zeros((rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    return out.index_add_(0, ii, vv[:, None] * b.index_select(0, kk))


def entry_fma(ii: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor,
              b: torch.Tensor, rows: int, *,
              check_range: bool = True) -> torch.Tensor:
    """``C[ii[e], :] += vv[e] * b[kk[e], :]`` over all entries into a zero
    (rows, lanes) float32 tile: the K6 CUDA kernel for CUDA tensors, the
    plain version for CPU ones.

    Args:
      ii, kk: (E,) int32 output and source row of each entry, in
        ``[0, rows)`` (checked on the host; one small device read).
      vv: (E,) float32 value of each entry.
      b: (rows, lanes) float32, contiguous.
      rows: the tile's height.
      check_range: False skips the range check of ``ii`` and ``kk`` (two
        device reads that wait for the stream). Only for a caller that has
        already made this call once with the same indices, such as a
        timing loop: the kernel itself does no bounds checks.
    """
    if not b.is_cuda:
        return entry_fma_reference(ii, kk, vv, b, rows)
    global LAUNCHES
    from ...runtime import cuda_kernels

    _check(ii, kk, vv, b, rows, check_range)
    for name, t in (("ii", ii), ("kk", kk), ("vv", vv), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"entry_fma: {name} must be contiguous")
    lanes = int(b.shape[1])
    out = torch.empty((rows, lanes), dtype=torch.float32, device=b.device)
    vec = 4 if lanes % 4 == 0 and b.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0 else 1
    lib = cuda_kernels.load()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        status = lib.bsm_entry_fma(
            ii.data_ptr(), kk.data_ptr(), vv.data_ptr(), b.data_ptr(),
            out.data_ptr(), int(ii.shape[0]), rows, lanes, vec, stream)
    LAUNCHES += 1
    cuda_kernels.check_launch(lib, status, "entry_fma")
    return out
