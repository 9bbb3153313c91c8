"""Panel-window add-back for the supernodal delta scatter: the K5 wrapper
and its plain version.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/panel_addback.py``.
:func:`panel_addback` adds ``psh[s, w]`` into ``lvals[tcp[s, w] : tcp[s, w]
+ col_len]`` for every panel ``s`` and column ``w < twd[s]``. The TPU
kernel moves 1024-aligned DMA windows because Mosaic demands aligned DMA
shapes; on the GPU this is the same function as K4 over a 2-D slot
layout, so the wrapper flattens ``(tcp, twd)`` into per-slot starts (-1
for a dead slot) for the plain ``index_add_`` version, which a CPU tensor
takes; for a CUDA tensor it hands ``tcp`` and ``twd`` as they are to the
span entry of ``csrc/addback.cu``, which tells the dead columns itself (or
it raises).
In place, as K4; returns ``lvals``. :func:`panel_addback_rects` is the same
update taken from the unsheared rects (the rect entry of that source, see
``addback_resident.addback_rects``). ``LAUNCHES`` counts the launches made
through this module's wrappers.
"""

from __future__ import annotations

import torch

from .addback_resident import (
    addback_rects_reference,
    addback_spans,
    addback_spans_reference,
    launch_rects,
)

# Launches of the add-back kernel through panel_addback (K5) in this
# process (a plain counter that a caller may reset to 0).
LAUNCHES = 0


def _check(psh: torch.Tensor, tcp: torch.Tensor, twd: torch.Tensor) -> None:
    if psh.ndim != 3 or tcp.shape != psh.shape[:2] \
            or twd.shape != psh.shape[:1]:
        raise ValueError(f"panel_addback takes psh (St, Wt, L), tcp (St, Wt) "
                         f"and twd (St,), got {tuple(psh.shape)}, "
                         f"{tuple(tcp.shape)}, {tuple(twd.shape)}")


def _flatten(psh: torch.Tensor, tcp: torch.Tensor, twd: torch.Tensor):
    _check(psh, tcp, twd)
    wv = torch.arange(psh.shape[1], device=psh.device)
    starts = torch.where(wv[None, :] < twd[:, None], tcp,
                         torch.full_like(tcp, -1))
    return psh.reshape(-1, psh.shape[2]), starts.reshape(-1).to(torch.int32)


def panel_addback_reference(lvals: torch.Tensor, psh: torch.Tensor,
                            tcp: torch.Tensor,
                            twd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5 (in place; returns ``lvals``)."""
    rows, starts = _flatten(psh, tcp, twd)
    return addback_spans_reference(lvals, rows, starts)


def panel_addback(lvals: torch.Tensor, psh: torch.Tensor, tcp: torch.Tensor,
                  twd: torch.Tensor) -> torch.Tensor:
    """Add sheared per-panel delta columns into their storage runs, in
    place.

    Live spans may overlap. On a CUDA tensor every add is an atomic
    reduction, so the float32 sum into an element hit by several slots is
    not bitwise reproducible from run to run; disjoint spans are (one add an
    element).

    Args:
      lvals: (N,) float32 factor values (updated in place and returned).
      psh: (St, Wt, col_len) float32 sheared deltas.
      tcp: (St, Wt) int32 column storage starts.
      twd: (St,) int32 live column count per panel.
    """
    if not lvals.is_cuda:
        return panel_addback_reference(lvals, psh, tcp, twd)
    global LAUNCHES
    _check(psh, tcp, twd)
    # the kernel tells the dead columns from twd: no starts array is built
    out = addback_spans(lvals, psh.reshape(-1, psh.shape[2]),
                        tcp.reshape(-1).to(torch.int32), "panel_addback",
                        twd.to(torch.int32))
    LAUNCHES += 1
    return out


def panel_addback_rects(lvals: torch.Tensor, p: torch.Tensor,
                        tcp: torch.Tensor, tnr: torch.Tensor,
                        twd: torch.Tensor) -> torch.Tensor:
    """``addback_resident.addback_rects`` counted as a K5 launch: the one-hot
    shear, the negation and :func:`panel_addback` in one kernel launch on a
    CUDA tensor (or it raises), ``addback_rects_reference`` on a CPU one.
    Same arguments, in place; returns ``lvals``."""
    if not lvals.is_cuda:
        return addback_rects_reference(lvals, p, tcp, tnr, twd)
    global LAUNCHES
    out = launch_rects(lvals, p, tcp, tnr, twd, "panel_addback_rects")
    LAUNCHES += 1
    return out
