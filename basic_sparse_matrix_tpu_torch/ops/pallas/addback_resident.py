"""Column add-back for the supernodal update scatter: the K4 CUDA kernel,
its plain version, the shear of merged rects into storage rows, and the
rect entry that folds the shear into the kernel.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/addback_resident.py``.
:func:`addback_resident` adds ``psh2[c]`` into ``lvals[tcpf[c] :
tcpf[c] + col_pad]`` for every slot with ``tcpf[c] >= 0``:

* on a CUDA tensor with the span entry of the hand-written kernel
  ``csrc/addback.cu`` (warps over slots, 16-byte atomic reductions on the
  destination's grid, each row cut at its last nonzero), or it raises;
* on a CPU tensor with :func:`addback_resident_reference`, an
  ``index_add_`` over the live spans.

Unlike the JAX function, which returns a new array, both add **in place**
into ``lvals`` (the factorization owns it, and a copy per level would cost
a factor-sized write) and return it. Elements past the end of ``lvals``
are dropped. ``panel_addback`` (K5) computes the same function over a
(panel, column) slot layout and shares the kernel and the plain version
(:func:`addback_spans`, :func:`addback_spans_reference`). Both span
wrappers stay as the counterparts of the JAX package's two kernels; the
factorization calls neither.

:func:`addback_rects` is the same update taken from the merged rects as the
level's products leave them, ``lvals[tcp[s, w] + r - w] -= p[s, r, w]``: on
a CUDA tensor the rect entry of the same source reads ``p`` where it lies,
so :func:`shear_reshape`, the negation and the pads to a class shape are
never built; :func:`addback_rects_reference` composes them. This is the
factorization's one add-back, on both devices (``supernodal_scatter``'s
``"rects"`` route). ``LAUNCHES`` counts the launches made through this
module's wrappers (both entries).

Batches: the rect entry takes a leading batch axis, ``lvals`` (Bt, N) and
``p`` (Bt, St, Rd, Wt) with the tables shared (one pattern, ``Bt`` sets of
values), in one launch; this is what the batched factorization launches.
The span entry (:func:`addback_resident`, and ``panel_addback`` called by
name) takes one system on the card; its plain version also takes a batch,
``lvals`` (Bt, N) with ``rows`` (Bt, C, L), as the JAX package's kernels
do under ``jax.vmap``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Launches of the add-back kernel through this module's wrappers
# (addback_resident, addback_rects) in this process (a plain counter that a
# caller may reset to 0).
LAUNCHES = 0


def _check(lvals: torch.Tensor, rows: torch.Tensor,
           starts: torch.Tensor) -> None:
    if lvals.ndim not in (1, 2) or rows.ndim != lvals.ndim + 1 \
            or rows.shape[:-2] != lvals.shape[:-1] or starts.ndim != 1 \
            or starts.shape[0] != rows.shape[-2]:
        raise ValueError(f"add-back takes lvals (N,), rows (C, L) and "
                         f"starts (C,), or lvals (Bt, N) with rows (Bt, C, "
                         f"L), got {tuple(lvals.shape)}, "
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
    row into its span of ``lvals`` (in place; returns ``lvals``). With a
    batch, system ``b``'s rows go into ``lvals[b]`` at the shared starts."""
    _check(lvals, rows, starts)
    live = torch.nonzero(starts >= 0).reshape(-1)
    idx = starts[live].long()[:, None] + torch.arange(
        rows.shape[-1], device=lvals.device)
    keep = idx < lvals.shape[-1]
    lvals.index_add_(-1, idx[keep], rows[..., live, :][..., keep])
    return lvals


def addback_spans(lvals: torch.Tensor, rows: torch.Tensor,
                  starts: torch.Tensor, what: str,
                  twd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the span entry of the add-back kernel on CUDA tensors (in
    place; returns ``lvals``). With ``twd`` (P,) int32 the C slots are laid
    out (P, C / P) and slot (s, w) is dead from ``w = twd[s]`` on, whatever
    ``starts`` holds there. One system: a batched ``lvals`` raises (the
    batched factorization launches the rect entry). The caller counts the
    launch."""
    from ...runtime import cuda_kernels

    if lvals.ndim != 1:
        raise ValueError(f"{what}: the span entry takes one system on the "
                         f"card, got lvals {tuple(lvals.shape)}; a batch "
                         f"goes through addback_rects")
    _check(lvals, rows, starts)
    if not lvals.is_contiguous():
        raise ValueError("lvals must be contiguous: the add-back is in place")
    rows = rows.contiguous()
    starts = starts.contiguous()
    wt = 0
    if twd is not None:
        if twd.dtype != torch.int32 or twd.device != lvals.device \
                or twd.ndim != 1 or starts.shape[0] % max(twd.shape[0], 1):
            raise ValueError(f"twd must be int32 (P,) on lvals' device with "
                             f"P dividing the slots, got {twd.dtype} "
                             f"{tuple(twd.shape)} on {twd.device}")
        twd = twd.contiguous()
        wt = starts.shape[0] // max(twd.shape[0], 1)
    lib = cuda_kernels.load()
    with torch.cuda.device(lvals.device):
        stream = torch.cuda.current_stream(lvals.device).cuda_stream
        status = lib.bsm_addback(lvals.data_ptr(), int(lvals.shape[0]),
                                 rows.data_ptr(), starts.data_ptr(),
                                 None if twd is None else twd.data_ptr(), wt,
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

    Live spans may overlap. On a CUDA tensor every add is an atomic
    reduction, so the float32 sum into an element hit by several slots is
    not bitwise reproducible from run to run; disjoint spans are (one add an
    element).

    Args:
      lvals: (N,) float32 factor values (updated in place and returned);
        on the CPU also (Bt, N), a batch of one pattern's values, with
        ``psh2`` (Bt, CQ, col_pad). The span entry on the card takes one
        system and raises on a batch.
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

    ``p_neg`` is (..., St, Rd, Wt) (already negated deltas). The storage
    image of rect column ``w`` is ``p[s, q + w, w]`` for ``q in [0,
    col_pad)``. Transposing to (St, Wt, Rd) and padding each (Wt, L)
    row-plane with Wt extra elements makes the shift by w fall out of a
    row-major reshape:

        flat[s, w*L + r] = pT[s, w, r]          (L = col_pad + Wt)
        out[s, w, q]     = flat[s, w*(L+1) + q] = pT[s, w, q + w]

    For q < col_pad the offset ``q + w`` stays inside row ``w``, and pT is
    zero beyond the live Rd rows, so nothing wraps. Plain tensor ops, no
    kernel. Returns (..., St, Wt, col_pad)."""
    *lead, st, rd, wt = p_neg.shape
    L = col_pad + wt
    pt = p_neg.transpose(-2, -1)                        # (St, Wt, Rd)
    pt = F.pad(pt, (0, L - rd))                         # zero rows past Rd
    flat = F.pad(pt.reshape(*lead, st, wt * L), (0, wt))
    return flat.reshape(*lead, st, wt, L + 1)[..., :col_pad]


def _check_rects(lvals, p, tcp, tnr, twd) -> None:
    if lvals.ndim not in (1, 2) or p.ndim != lvals.ndim + 2 \
            or p.shape[:-3] != lvals.shape[:-1] \
            or tcp.shape != (p.shape[-3], p.shape[-1]) \
            or tnr.shape != p.shape[-3:-2] or twd.shape != p.shape[-3:-2]:
        raise ValueError(f"rect add-back takes lvals (N,) with p (St, Rd, "
                         f"Wt), or lvals (Bt, N) with p (Bt, St, Rd, Wt), "
                         f"tcp (St, Wt), tnr and twd (St,), got "
                         f"{tuple(lvals.shape)}, {tuple(p.shape)}, "
                         f"{tuple(tcp.shape)}, {tuple(tnr.shape)}, "
                         f"{tuple(twd.shape)}")
    if lvals.dtype != torch.float32 or p.dtype != torch.float32:
        raise TypeError(f"rect add-back takes float32 lvals and p, got "
                        f"{lvals.dtype}, {p.dtype}")
    if tcp.dtype not in (torch.int32, torch.int64) \
            or not (tcp.dtype == tnr.dtype == twd.dtype):
        raise TypeError(f"tcp, tnr and twd must share int32 or int64, got "
                        f"{tcp.dtype}, {tnr.dtype}, {twd.dtype}")
    if not (lvals.device == p.device == tcp.device == tnr.device
            == twd.device):
        raise ValueError("lvals, p, tcp, tnr and twd must share one device")


def addback_rects_reference(lvals: torch.Tensor, p: torch.Tensor,
                            tcp: torch.Tensor, tnr: torch.Tensor,
                            twd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the rect entry (in place; returns
    ``lvals``): mask the rects to their live trapezoids, shear and negate
    them (:func:`shear_reshape`) and add the rows with
    :func:`addback_resident_reference`; a batch (``lvals`` (Bt, N), ``p``
    (Bt, St, Rd, Wt)) in the same ops with a leading axis."""
    _check_rects(lvals, p, tcp, tnr, twd)
    st, rd, wt = p.shape[-3:]
    rr = torch.arange(rd, device=p.device)[None, :, None]
    ww = torch.arange(wt, device=p.device)[None, None, :]
    live = (ww < twd[:, None, None]) & (rr >= ww) & (rr < tnr[:, None, None])
    psh = shear_reshape(-torch.where(live, p, 0.0), rd)
    tcpf = torch.where(ww[0] < twd[:, None], tcp, -1)
    return addback_resident_reference(
        lvals, psh.reshape(*p.shape[:-3], st * wt, rd),
        tcpf.reshape(-1).to(torch.int32))


def addback_rects(lvals: torch.Tensor, p: torch.Tensor, tcp: torch.Tensor,
                  tnr: torch.Tensor, twd: torch.Tensor) -> torch.Tensor:
    """Subtract merged update rects from their panels' storage, in place:
    ``lvals[tcp[s, w] + r - w] -= p[s, r, w]`` for ``w < twd[s]`` and ``w <=
    r < tnr[s]``; every other element of ``p`` (the upper wedge, rows past a
    panel's rect, dead columns) is ignored, and an index outside ``lvals``
    is dropped. The shear, the negation and :func:`addback_resident` in one
    kernel launch on a CUDA tensor (or it raises); their composition,
    :func:`addback_rects_reference`, on a CPU tensor.

    Columns of one panel, and panels of one level, may share storage only
    through a caller's choice of ``tcp``; where they do the adds are atomic
    and their float32 order is not fixed.

    Args:
      lvals: (N,) float32 factor values (updated in place and returned), or
        (Bt, N): a batch of one pattern's values, one launch for all.
      p: (St, Rd, Wt) float32 merged rects, not negated; (Bt, St, Rd, Wt)
        with a batched ``lvals``.
      tcp: (St, Wt) int32 or int64 storage start of each panel column.
      tnr: (St,) rect rows of each panel; twd: (St,) its live columns
        (both of ``tcp``'s dtype).
    """
    if not lvals.is_cuda:
        return addback_rects_reference(lvals, p, tcp, tnr, twd)
    from ...runtime import cuda_kernels

    global LAUNCHES
    _check_rects(lvals, p, tcp, tnr, twd)
    if not lvals.is_contiguous():
        raise ValueError("lvals must be contiguous: the add-back is in place")
    p, tcp, tnr, twd = (t.contiguous() for t in (p, tcp, tnr, twd))
    bt = lvals.shape[0] if lvals.ndim == 2 else 1
    lib = cuda_kernels.load()
    with torch.cuda.device(lvals.device):
        stream = torch.cuda.current_stream(lvals.device).cuda_stream
        status = lib.bsm_addback_rects(
            lvals.data_ptr(), int(lvals.shape[-1]), p.data_ptr(),
            tcp.data_ptr(), tnr.data_ptr(), twd.data_ptr(), bt,
            *(int(d) for d in p.shape[-3:]), int(tcp.dtype == torch.int64),
            stream)
    cuda_kernels.check_launch(lib, status, "addback_rects")
    LAUNCHES += 1
    return lvals
