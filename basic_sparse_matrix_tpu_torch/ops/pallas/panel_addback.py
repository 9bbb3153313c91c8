"""Panel-window add-back for the supernodal delta scatter: the K5 wrapper
and its plain version.

Counterpart of ``basic_sparse_matrix_tpu/ops/pallas/panel_addback.py``.
:func:`panel_addback` adds ``psh[s, w]`` into ``lvals[tcp[s, w] : tcp[s, w]
+ col_len]`` for every panel ``s`` and column ``w < twd[s]``. The TPU
kernel moves 1024-aligned DMA windows because Mosaic demands aligned DMA
shapes; on the GPU this is the same function as K4 over a 2-D slot
layout, so the wrapper flattens ``(tcp, twd)`` into per-slot starts (-1
for a dead slot) and runs the add-back kernel of ``csrc/addback.cu`` for a
CUDA tensor (or raises), the plain ``index_add_`` version for a CPU one.
In place, as K4; returns ``lvals``. ``LAUNCHES`` counts the launches made
through this wrapper.
"""

from __future__ import annotations

import torch

from .addback_resident import addback_spans, addback_spans_reference

# Launches of the add-back kernel through panel_addback (K5) in this
# process (a plain counter that a caller may reset to 0).
LAUNCHES = 0


def _flatten(psh: torch.Tensor, tcp: torch.Tensor, twd: torch.Tensor):
    if psh.ndim != 3 or tcp.shape != psh.shape[:2] \
            or twd.shape != psh.shape[:1]:
        raise ValueError(f"panel_addback takes psh (St, Wt, L), tcp (St, Wt) "
                         f"and twd (St,), got {tuple(psh.shape)}, "
                         f"{tuple(tcp.shape)}, {tuple(twd.shape)}")
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

    Args:
      lvals: (N,) float32 factor values (updated in place and returned).
      psh: (St, Wt, col_len) float32 sheared deltas.
      tcp: (St, Wt) int32 column storage starts.
      twd: (St,) int32 live column count per panel.
    """
    if not lvals.is_cuda:
        return panel_addback_reference(lvals, psh, tcp, twd)
    global LAUNCHES
    rows, starts = _flatten(psh, tcp, twd)
    out = addback_spans(lvals, rows, starts, "panel_addback")
    LAUNCHES += 1
    return out
