"""SpMM (CSR × dense) and SpMV — the main path of the port.

Counterpart of ``basic_sparse_matrix_tpu/ops/spmm.py`` (reference
``mul_dense``/``mul_vector``, ``src/sparse.rs:426-482``). ``spmm_auto``
keeps the JAX package's dispatch ladder and thresholds, and adds one rung
on the card:

1. dense: ``torch.matmul`` on the memoised densified operand, when density
   ≥ ``dense_dispatch_density`` and the dense matrix takes at most
   ``dense_dispatch_max_bytes`` (the JAX package leaves this product to XLA);
2. BSR: the K1 CUDA kernel (``ops/pallas/spmm_kernel.py``) when
   ``bsr_profitable`` and the card's kernel choice (below) takes it;
3. ELL, when the ELL overhead (memoised on the CSR) is at most
   ``ell_max_overhead``: K8, or the K2 streaming kernel, on the card, as
   the kernel choice takes them;
   gather + per-row reduce elsewhere (``ops/ell.py``,
   ``ops/pallas/stream_kernel.py``);
4. split (the card only, float32): above that overhead, each row cut into
   pieces of at most ``ops/split.py::WIDTH`` entries, run as an ELL on K8,
   the pieces' sums added by K8 in a fixed tree (``ops/split.py``);
5. ``spmm``: gather + ``index_add_`` segment sum, any shape.

The card's kernel choice (:func:`_card_kernel`): a float32 product of at
least ``CARD_MIN_COLUMNS`` columns on a CUDA device, which the rungs above
would send to K1 (BSR), K2 (streaming) or K8 (ELL), takes the one of them
whose modelled device time on this layout is least (:func:`card_costs`):
the same rungs' gates decide which are candidates (``bsr_profitable`` for
K1, the ELL overhead for K8, ``ell_stream`` and K2's size gate for K2), and
the layout's numbers (block fill at ``pick_tiles``' tile, the ELL overhead,
rows, columns, entries, N) decide among them. So a stencil's wide product
leaves K1's padded blocks for K8, and a block-dense operand keeps K1. The
BSR layout and the stream plan are built only for the kernel chosen.

Dispatch rule for the kernels: the BSR, streaming and ELL kernels (and so
the split rung) take float32 only. A matrix or RHS of another dtype on a
CUDA device (the integer-dtype cases) takes the plain rungs 1, 3 (gather +
reduce) and 5, chosen before any launch — never by catching a failed one.
On the CPU the kernel rungs are off, as they are off the TPU in the JAX
package, so the ladder picks the same rung as the JAX package on the CPU.

A 1-D operand is one column (N = 1) everywhere on the ladder.
``mul_vector`` (and ``SparseOperator.matvec``) sends a float32 vector times
a float32 matrix on a CUDA device down the ladder, so an SpMV there runs
K8 on an ELL operator and the split rung on a skewed one; every other
SpMV, on the CPU or of another dtype, keeps the JAX package's gather +
segment sum in the vector's dtype (``spmv``).

Result dtypes follow the JAX package: ``spmm``/``spmv`` and the ELL rung
return the RHS's dtype; the dense rung and the kernels return float32.

Batches (``jax.vmap`` in the JAX package): ``spmm_auto``/``mul_dense`` with
``b`` of shape (Bt, K, N) fold the batch into the columns, so the (K, Bt·N)
product takes one pass down the ladder (the kernels at full width), and
unfold the result to (Bt, M, N). ``spmm(a, b, values=V)`` with ``V`` (Bt,
nnz) multiplies ``Bt`` matrices of ``a``'s pattern: the gather rung with a
batch axis, the rung JAX's ``vmap`` over the values takes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..runtime import profiling
from ..utils.config import get_config, matmul_precision
from ..utils.errors import IncorrectDimensions, check
from . import ell as _e
from . import split as _s
from .csr import CSR, compute_dtype
from .pallas import spmm_kernel as _k
from .pallas import stream_kernel as _sk


def _as_tensor(x, a: CSR) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=a.device)


# Bytes of gathered rows one chunk of the batched-values gather may hold.
VALUES_CHUNK_BYTES = 1 << 30


def spmm(a: CSR, b: torch.Tensor,
         values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather-based SpMM: ``out[i, :] = Σ_k A[i,k]·B[k, :]``: gather the rows
    of ``B`` by column index, scale by the stored values, and add them into
    their output rows.

    ``values`` (Bt, nnz) replaces ``a.values`` by ``Bt`` value sets of the
    same pattern: ``b`` (K, N), or (Bt, K, N) one per system, gives (Bt, M,
    N), in entry chunks of at most ``VALUES_CHUNK_BYTES`` of gathered rows
    for the whole batch."""
    if values is not None:
        return _spmm_values(a, b, values)
    cdt = compute_dtype(b.dtype)
    gathered = b.to(cdt).index_select(0, a.indices) \
        * a.values.to(cdt).unsqueeze(1)
    out = torch.zeros((a.rows, b.shape[1]), dtype=cdt, device=b.device)
    out.index_add_(0, a.row_ids(), gathered)
    return out.to(b.dtype)


def _spmm_values(a: CSR, b: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    check(values.ndim == 2 and values.shape[1] == a.stored
          and b.ndim in (2, 3) and b.shape[-2] == a.cols
          and (b.ndim == 2 or b.shape[0] == values.shape[0]),
          IncorrectDimensions,
          f"spmm with values: {a.dims}, {a.stored} stored, values "
          f"{tuple(values.shape)}, b {tuple(b.shape)}")
    bt, n = values.shape[0], b.shape[-1]
    cdt = compute_dtype(b.dtype)
    bc, vals = b.to(cdt), values.to(cdt)
    rows = a.row_ids()
    out = torch.zeros((bt, a.rows, n), dtype=cdt, device=b.device)
    per_entry = bt * n * out.element_size()
    chunk = max(1, VALUES_CHUNK_BYTES // max(per_entry, 1))
    for e0 in range(0, a.stored, chunk):
        cols = a.indices[e0: e0 + chunk]
        gathered = bc.index_select(-2, cols) \
            * vals[:, e0: e0 + chunk, None]             # (Bt, e, N)
        out.index_add_(1, rows[e0: e0 + chunk], gathered)
    return out.to(b.dtype)


def spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """Sparse matrix × vector: the N=1 gather/segment sum."""
    cdt = compute_dtype(x.dtype)
    prod = a.values.to(cdt) * x.to(cdt).index_select(0, a.indices)
    out = torch.zeros(a.rows, dtype=cdt, device=x.device)
    out.index_add_(0, a.row_ids(), prod)
    return out.to(x.dtype)


def mul_dense(a: CSR, b) -> torch.Tensor:
    """Checked SpMM entry point — reference ``mul_dense`` including its
    ``IncorrectDimensions`` error. ``b`` (K, N), or a batch (Bt, K, N)."""
    b = _as_tensor(b, a)
    check(b.ndim in (2, 3) and a.cols == b.shape[-2], IncorrectDimensions,
          f"mul_dense: {a.dims} × {tuple(b.shape)}")
    return spmm_auto(a, b)


def mul_vector(a: CSR, x) -> torch.Tensor:
    """Checked SpMV — reference ``mul_vector``. A float32 vector times a
    float32 matrix on a CUDA device takes the dispatch ladder
    (``spmm_auto``) as one column; any other ``spmv``, in ``x``'s dtype."""
    x = _as_tensor(x, a)
    check(x.ndim == 1 and a.cols == x.shape[0], IncorrectDimensions,
          f"mul_vector: {a.dims} × {tuple(x.shape)}")
    if x.is_cuda and x.dtype == a.dtype == torch.float32:
        return spmm_auto(a, x)
    return spmv(a, x)


def spmm_to_csr(a: CSR, b) -> CSR:
    """Reference-shaped result: the dense product re-sparsified (exact
    zeros dropped), on ``a``'s device. Host-side."""
    return CSR.from_dense(mul_dense(a, b).cpu().numpy(), device=a.device)


# The card's kernel choice (module docstring). Products narrower than this
# keep the ladder's rungs as they are (K1 opens at 64 columns too).
CARD_MIN_COLUMNS = 64
# Modelled device seconds of each kernel's work (card_costs), fitted to the
# rows of ``probes/ell_probe.py --choice`` on an H100 (PERF.md, section 6):
K1_SLAB_S = 5.2e-13      # an element of the bk x N slab of X a live block reads
K1_MAC_S = 3.4e-14       # a multiply-add of a live block (three TF32 passes)
K8_SLOT_S = 8.9e-13      # an ELL slot's column and value
K8_ELEMENT_S = 2.5e-13   # an element of X a slot gathers, from the caches
K2_SWEEP_S = 1.05e-11    # a stored entry's plan slot, in one sweep of a slice
DRAM_BYTE_S = 2.76e-13   # a byte of X or C moved to or from device memory
LAUNCH_S = 5.0e-5        # what any product costs beyond its work
# K2's tile kernel (where the sliced kernel does not apply) took 1.20 to 9.3
# times K8's time on every probed shape: it is modelled as K8's time times
# the least of these.
K2_TILE_OVER_K8 = 1.2
# K1 covers N in tiles of this many columns.
K1_TILE_N = 128


def card_layout(a: CSR, b: torch.Tensor) -> dict:
    """The numbers of ``a``'s layout that the card's choice reads: rows,
    columns, stored entries, N (``b``'s columns, 1 for a vector), the tile
    (bm, bk) and live blocks of the BSR layout (from its memo, else from
    ``bsr_profitable``'s fill test, run here where neither exists) and the
    ELL overhead."""
    n = 1 if b.ndim == 1 else int(b.shape[-1])
    bsr = a._bsr_cache
    if bsr is not None:
        bm, bk, live = bsr.bm, bsr.bk, bsr.n_live
    else:
        if a._bsr_fill is None:
            _k.bsr_profitable(a, b, force=True)
        bm, bk = _k.pick_tiles(a.rows, a.cols, a.stored)
        live = a.stored / (a._bsr_fill * bm * bk) if a._bsr_fill else 0
    return dict(rows=a.rows, cols=a.cols, stored=a.stored, n=n, bm=bm,
                bk=bk, live=live, overhead=_e.ell_overhead(a))


def _dram_x_bytes(layout: dict, piece: int) -> float:
    """Bytes of X that gathers of ``piece``-byte pieces of its rows read
    from device memory: X once where its pieces fit the L2, else one piece
    for each live block (a block's entries share the rows they read),
    less the share the L2 holds, and never less than X once."""
    whole = layout["cols"] * piece
    if whole <= _sk.L2_SLICE_BUDGET_BYTES:
        return whole
    missed = layout["live"] * piece * (1 - _sk.L2_SLICE_BUDGET_BYTES / whole)
    return max(whole, missed)


def card_costs(layout: dict) -> Dict[str, float]:
    """Modelled device seconds of one product on ``layout`` (see
    :func:`card_layout`) by K1, K2 and K8, each ``LAUNCH_S`` plus its work
    plus writing C:

    * K1: every live block reads a bk x N slab of X and makes bm x bk x N
      multiply-adds in three TF32 passes, N rounded up to ``K1_TILE_N``;
    * K8: every ELL slot (overhead x stored) reads its column and value and
      gathers a row of X, N x 4 bytes;
    * K2: where the sliced kernel applies, every stored entry's plan slot is
      swept once for each slice of ``SLICE_WIDTH`` columns, and each sweep
      gathers that slice's pieces of X; elsewhere the tile kernel, at
      ``K2_TILE_OVER_K8`` times K8.

    The pieces of X that miss the L2 (:func:`_dram_x_bytes`) and C are
    charged at ``DRAM_BYTE_S`` a byte."""
    n, stored = layout["n"], layout["stored"]
    bm, bk, live = layout["bm"], layout["bk"], layout["live"]
    slots = layout["overhead"] * stored
    fixed = LAUNCH_S + 4 * layout["rows"] * n * DRAM_BYTE_S
    n1 = -(-n // K1_TILE_N) * K1_TILE_N
    k1 = fixed + live * n1 * (bk * K1_SLAB_S + bm * bk * K1_MAC_S)
    k8 = fixed + slots * (K8_SLOT_S + n * K8_ELEMENT_S) \
        + _dram_x_bytes(layout, 4 * n) * DRAM_BYTE_S
    tile_k = get_config().cuda_stream_tile_k
    n_kt = -(-layout["cols"] // tile_k) if tile_k else 1
    width = _sk.slice_width(layout["cols"], n, n_kt)
    if width and (slots / max(layout["rows"], 1)) * _sk.LONG_ROW_ROWS \
            <= layout["rows"]:
        sweeps = -(-n // width)
        k2 = fixed + sweeps * (stored * K2_SWEEP_S
                               + _dram_x_bytes(layout, 4 * width)
                               * DRAM_BYTE_S)
    else:
        k2 = k8 * K2_TILE_OVER_K8
    return {"k1": k1, "k2": k2, "k8": k8}


def card_pick(layout: dict, candidates) -> str:
    """The candidate (of ``"k1"``, ``"k2"``, ``"k8"``) whose
    :func:`card_costs` on ``layout`` is least."""
    costs = card_costs(layout)
    return min(candidates, key=costs.__getitem__)


def _card_kernel(a: CSR, b: torch.Tensor) -> Optional[str]:
    """The card's kernel for ``a`` x ``b``: ``"k1"``, ``"k2"`` or ``"k8"``,
    or None where the choice is not reached (off the card, another dtype
    than float32, fewer than ``CARD_MIN_COLUMNS`` columns, no entries, or
    neither the BSR nor the ELL rung open). The candidates are those whose
    rung's gate holds; of them the least :func:`card_costs`. Counts
    ``spmm.card.decisions`` at every choice made, and
    ``spmm.card.bsr_declined`` where ``bsr_profitable`` held and another
    kernel was chosen."""
    n = 1 if b.ndim == 1 else int(b.shape[-1])
    if not (b.is_cuda and a.dtype == torch.float32
            and b.dtype == torch.float32 and n >= CARD_MIN_COLUMNS
            and a.stored):
        return None
    cfg = get_config()
    bsr = _k.bsr_profitable(a, b)
    ell = _e.ell_overhead(a) <= cfg.ell_max_overhead
    if not (bsr or ell):
        return None
    candidates = (["k1"] if bsr else []) + (["k8"] if ell else [])
    if ell and _e.stream_gate(a, b):
        candidates.append("k2")
    pick = card_pick(card_layout(a, b), candidates)
    profiling.count("spmm.card.decisions")
    if bsr and pick != "k1":
        profiling.count("spmm.card.bsr_declined")
    return pick


def _rung(a: CSR, b: torch.Tensor) -> str:
    """The ladder's rung for ``a`` × ``b`` ((K,) or (K, N)): ``dense``,
    ``bsr``, ``stream`` (K2, where the card's choice takes it), ``ell``
    (the ELL path: K8 or the gather + reduce), ``split`` or ``gather``."""
    cfg = get_config()
    if (a.get_density() >= cfg.dense_dispatch_density
            and 4 * a.rows * a.cols <= cfg.dense_dispatch_max_bytes):
        return "dense"
    # Where the choice is not reached, bsr_profitable does not hold either
    # (it needs the card, 64 columns and entries): the BSR rung is closed.
    card = _card_kernel(a, b)
    if card is not None:
        return {"k1": "bsr", "k2": "stream", "k8": "ell"}[card]
    if a.stored and _e.ell_overhead(a) <= cfg.ell_max_overhead:
        return "ell"
    if (b.is_cuda and a.dtype == torch.float32 and b.dtype == torch.float32
            and a.stored):
        return "split"
    return "gather"


def spmm_auto(a: CSR, b: torch.Tensor) -> torch.Tensor:
    """Density-dispatched SpMM (the ladder in the module docstring). A batch
    ``b`` (Bt, K, N) is folded into the columns, (K, Bt·N), multiplied in
    one pass down the ladder and unfolded to (Bt, M, N); a vector ``b``
    (K,) gives (M,).

    The recorder (``runtime/profiling.py``) sees the choice as the span
    ``bsm.spmm.dispatch`` and the counter ``spmm.rung.<rung>`` (``dense``,
    ``bsr``, ``ell``, ``stream``, ``split`` or ``gather``), and the product
    as the span ``bsm.spmm.<rung>``. The memoised dense operand is the
    set-up lap ``spmm.dense_convert``, as the other rungs' layouts are
    theirs (``spmm.split_convert`` the split layout's)."""
    if b.ndim == 3:
        bt, k, n = b.shape
        folded = b.permute(1, 0, 2).reshape(k, bt * n)
        return spmm_auto(a, folded).reshape(a.rows, bt, n).transpose(0, 1) \
            .contiguous()
    with profiling.span("bsm.spmm.dispatch"):
        rung = _rung(a, b)
    if rung in ("ell", "stream"):
        return _e.spmm_ell_from_csr(a, b, stream=rung == "stream")
    profiling.count("spmm.rung." + rung)
    with profiling.span("bsm.spmm." + rung):
        if rung == "bsr":
            return _k.spmm_bsr_from_csr(a, b)
        if rung == "split":
            return _s.spmm_split(_s.cached_split(a), b)
        if rung == "gather":
            return spmm(a, b) if b.ndim == 2 else spmv(a, b)
        if a._dense_cache is None:
            clock = profiling.Laps("spmm", a.device)
            a._dense_cache = a.todense().to(torch.float32)
            clock.lap("dense_convert")
        with matmul_precision():
            return torch.matmul(a._dense_cache, b.to(torch.float32))
