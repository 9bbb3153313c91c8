"""Column add-back for the supernodal update scatter: the K4 CUDA kernel,
its plain version, and the shear of merged rects into storage rows.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/addback_resident.py``.
:func:`addback_resident` adds ``psh2[c]`` into ``lvals[tcpf[c] :
tcpf[c] + col_pad]`` for every slot with ``tcpf[c] >= 0``:

* on a CUDA tensor with the hand-written kernel ``csrc/addback.cu`` (one
  thread block per slot, atomic adds, since live spans may overlap), or it
  raises;
* on a CPU tensor with :func:`addback_resident_reference`, an
  ``index_add_`` over the live spans.

Unlike the JAX function, which returns a new array, both add **in place**
into ``lvals`` (the factorization owns it, and a copy per level would cost
a factor-sized write) and return it. Elements past the end of ``lvals``
are dropped. ``panel_addback`` (K5) computes the same function over a
(panel, column) slot layout and shares the kernel and the plain version
(:func:`addback_spans`, :func:`addback_spans_reference`). ``LAUNCHES``
counts the launches made through this wrapper.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Launches of the add-back kernel through addback_resident (K4) in this
# process (a plain counter that a caller may reset to 0).
LAUNCHES = 0


def _check(lvals: torch.Tensor, rows: torch.Tensor,
           starts: torch.Tensor) -> None:
    if lvals.ndim != 1 or rows.ndim != 2 or starts.ndim != 1 \
            or starts.shape[0] != rows.shape[0]:
        raise ValueError(f"add-back takes lvals (N,), rows (C, L) and "
                         f"starts (C,), got {tuple(lvals.shape)}, "
                         f"{tuple(rows.shape)}, {tuple(starts.shape)}")
    if lvals.dtype != torch.float32 or rows.dtype != torch.float32 \
            or starts.dtype != torch.int32:
        raise TypeError(f"add-back takes float32 lvals and rows and int32 "
                        f"starts, got {lvals.dtype}, {rows.dtype}, "
                        f"{starts.dtype}")
    if not (lvals.device == rows.device == starts.device):
        raise ValueError("lvals, rows and starts must share one device")


def addback_spans_reference(lvals: torch.Tensor, rows: torch.Tensor,
                            starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the add-back: ``index_add_`` of every live
    row into its span of ``lvals`` (in place; returns ``lvals``)."""
    _check(lvals, rows, starts)
    live = torch.nonzero(starts >= 0).reshape(-1)
    idx = starts[live].long()[:, None] + torch.arange(
        rows.shape[1], device=lvals.device)
    keep = idx < lvals.shape[0]
    lvals.index_add_(0, idx[keep], rows[live][keep])
    return lvals


def addback_spans(lvals: torch.Tensor, rows: torch.Tensor,
                  starts: torch.Tensor, what: str) -> torch.Tensor:
    """Launch the add-back kernel on CUDA tensors (in place; returns
    ``lvals``). The caller counts the launch."""
    from ...runtime import cuda_kernels

    _check(lvals, rows, starts)
    if not lvals.is_contiguous():
        raise ValueError("lvals must be contiguous: the add-back is in place")
    rows = rows.contiguous()
    starts = starts.contiguous()
    lib = cuda_kernels.load()
    with torch.cuda.device(lvals.device):
        stream = torch.cuda.current_stream(lvals.device).cuda_stream
        status = lib.bsm_addback(lvals.data_ptr(), int(lvals.shape[0]),
                                 rows.data_ptr(), starts.data_ptr(),
                                 int(rows.shape[0]), int(rows.shape[1]),
                                 stream)
    cuda_kernels.check_launch(lib, status, what)
    return lvals


def addback_resident_reference(lvals: torch.Tensor, psh2: torch.Tensor,
                               tcpf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (in place; returns ``lvals``)."""
    return addback_spans_reference(lvals, psh2, tcpf)


def addback_resident(lvals: torch.Tensor, psh2: torch.Tensor,
                     tcpf: torch.Tensor) -> torch.Tensor:
    """Add sheared delta rows into their storage runs, in place.

    Args:
      lvals: (N,) float32 factor values (updated in place and returned).
      psh2: (CQ, col_pad) float32, one sheared (already negated) delta row
        per flattened (panel, column) slot.
      tcpf: (CQ,) int32 storage start of each row, -1 for a dead slot.
    """
    if not lvals.is_cuda:
        return addback_resident_reference(lvals, psh2, tcpf)
    global LAUNCHES
    out = addback_spans(lvals, psh2, tcpf, "addback_resident")
    LAUNCHES += 1
    return out


def shear_reshape(p_neg: torch.Tensor, col_pad: int) -> torch.Tensor:
    """Shear merged rects to storage-image rows by a reshape.

    ``p_neg`` is (St, Rd, Wt) (already negated deltas). The storage image of
    rect column ``w`` is ``p[s, q + w, w]`` for ``q in [0, col_pad)``.
    Transposing to (St, Wt, Rd) and padding each (Wt, L) row-plane with Wt
    extra elements makes the shift by w fall out of a row-major reshape:

        flat[s, w*L + r] = pT[s, w, r]          (L = col_pad + Wt)
        out[s, w, q]     = flat[s, w*(L+1) + q] = pT[s, w, q + w]

    For q < col_pad the offset ``q + w`` stays inside row ``w``, and pT is
    zero beyond the live Rd rows, so nothing wraps. Plain tensor ops, no
    kernel. Returns (St, Wt, col_pad)."""
    st, rd, wt = p_neg.shape
    L = col_pad + wt
    pt = p_neg.transpose(1, 2)                          # (St, Wt, Rd)
    pt = F.pad(pt, (0, L - rd))                         # zero rows past Rd
    flat = F.pad(pt.reshape(st, wt * L), (0, wt))
    return flat.reshape(st, wt, L + 1)[:, :, :col_pad]
