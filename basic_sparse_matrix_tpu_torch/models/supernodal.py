"""Supernodal sparse Cholesky — panel-granular numeric phase.

Counterpart of ``basic_sparse_matrix_tpu/models/supernodal.py``. Columns
with identical below-diagonal structure (supernodes,
``runtime/symbolic.supernodes``, relaxed by ``supernodal_relax``) factor
as one dense panel, and every inter-supernode update is a dense outer
product ``L_d[I,:] @ L_d[J,:]ᵀ``, batched over all updates of a level.
Panel finalisation is a batched dense Cholesky and triangular solve over
the level's supernodes.

Schedule (host, numpy — :func:`analyze_supernodal`, ported line for line):
the factor pattern in CSC with the diagonal first, the supernode partition,
fan-in levels of the supernode etree, per-level compact index tables into
L's flat CSC value array, bucketed and grouped exactly as in the JAX
package. The tables go to the device one tensor per table per group, with
the ``uint16`` row tables widened to int32 (the JAX package packs them
into three flat buffers for its TPU transport); ``_host_tabs`` keeps the
numpy tables under the JAX names.

Numeric (device — :func:`factorize_supernodal`): a Python loop over groups
and over the levels of each group (the JAX package's ``lax.scan``), on the
card captured as one CUDA graph per schedule and replayed from the second
re-factorization on (the JAX package's ``jax.jit``). Each
level gathers its operands (element positions, or contiguous runs through
the K3 kernel ``ops/pallas/runs_read``), runs one batched product, applies
the updates by one of three routes (``"element"``: per-element scatter;
``"delta"``: target-rect scatter; ``"rects"``: the merged rects through
``ops/pallas/addback_resident.addback_rects``, the rect entry of the
add-back kernel on the card and its plain composition on the CPU), and
finalises its panels. Every einsum and batched product runs under
``utils.config.matmul_precision()``: the one-hot merges copy values
exactly only in full float32, so TF32 is off. Padding lands in a scratch
slot that is re-zeroed each step.

Batched values (the counterpart of ``jax.vmap`` over ``a_values``):
``factorize_supernodal`` takes ``a_values`` of shape (Bt, nnz) and factors
``Bt`` systems of one pattern on one schedule, ``lvals`` (Bt, nnz_l + pad)
with one scratch slot per system. Every step of a level runs once for the
whole batch: the gathers and K3 reads take the leading axis, the products
and the panel factors are batched over it, the scatters add along the last
axis, and on the card the add-back kernel's rect entry takes the batch in
one launch, so a batch launches K3 and the add-back exactly as often as
one system does. A panel that fails its Cholesky turns its own system's
values to NaN only. The host schedule is built once.

The per-group routing (``use_vmem``, ``use_pallas``, ``use_delta``,
``use_window``, ``kread``) comes from the JAX package's cost model, whose
constants (``_VMEM_*``, ``_KREAD_*``, ``_PALLAS_MIN_ELEMENTS``,
``_MERGE_CHUNK_ELEMS`` and the model in ``analyze_supernodal``) were set
for a TPU. They are kept, so that the schedule equals the JAX package's;
they are unmeasured on the H100. A group that the JAX package sends to
its K4 or K5 add-back (two TPU kernels of one function) takes the
``"rects"`` route here (:func:`_group_delta`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.csr import CSR, to_tensor
from ..runtime import graphs, symbolic
from ..utils.config import get_config, matmul_precision
from ..utils.errors import NonSquareMatrix, check

# Max update-table buckets per fan-in level; levels whose single-stack
# tables are under _BUCKET_MIN_VOLUME entries (or within 2x of the
# bucketed volume) are never split.
_MAX_BUCKETS = 3
_BUCKET_MIN_VOLUME = 1 << 20

# Per-group table names, in the order of SupernodalSchedule.tabs[gi].
_TABLE_NAMES = ("upd_base", "upd_meta", "upd_irows", "upd_ibelow",
                "upd_jrows", "upd_jcp", "panel_cp", "panel_r", "top_valid",
                "tgt_cp", "tgt_nrows", "tgt_w", "upd_seg")
_TABLE_INDEX = {name: i for i, name in enumerate(_TABLE_NAMES)}


@dataclasses.dataclass(eq=False)
class SupernodalSchedule:
    """Level tables padded per level, consecutive same-shape levels stacked
    into groups (leading axis g of every table).

    Compact tables (the full (U, I, W)/(U, J, W)/(U, I, J) position arrays
    are rebuilt per level by _upd_positions): upd_base (g,U,W) source col
    base; upd_meta (g,U,4) = (ni, nj, hi_s, c0_s); upd_irows/_ibelow
    (g,U,I) target rows / below ranks; upd_jrows/_jcp (g,U,J) target cols /
    col_ptr; panel_cp (g,S,W) col_ptr, panel_r (g,S) below counts,
    top_valid (g,S,W); tgt_cp (g,St,Wt), tgt_nrows/tgt_w (g,St), upd_seg
    (g,U) — the target-panel tables of the delta formulations.

    ``tabs[gi]`` holds group ``gi``'s 13 tables on the device (int32, bool
    for ``top_valid``); the host numpy tables, with the JAX package's
    dtypes, are reachable by name (``sched.upd_base[gi]``)."""

    a_src_pos: torch.Tensor          # (nnz(A lower),) int64
    a_vals_idx: torch.Tensor         # (nnz(A lower),) int64
    tabs: Tuple[Tuple[torch.Tensor, ...], ...]
    # per group: max below-row count of the panels (the R axis)
    panel_rmax: Tuple[int, ...]
    # per group: target-rect row count (delta formulations) and the host's
    # formulation choices
    delta_rmax: Tuple[int, ...]
    use_delta: Tuple[bool, ...]
    use_pallas: Tuple[bool, ...]
    # per group: add-back kernel shape class (CQ, col_pad) where the temps
    # fit, else None; and whether auto mode routes the group through it
    vmem_shape: Tuple
    use_vmem: Tuple[bool, ...]
    # matrix-level run-read classes ((l_pad, crq), ...) for K3; empty when
    # the factor is over the JAX package's resident budget
    kread: Tuple
    # per group: window reads win the read side (no kernel classes)
    use_window: Tuple[bool, ...]
    nnz_l: int
    n: int
    _host_tabs: Tuple = dataclasses.field(default=(), repr=False)
    avg_panel_width: float = 0.0
    # (csc_rows, csc_cols) of the (possibly expanded) factor pattern
    l_pattern: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False)

    @property
    def n_groups(self) -> int:
        return len(self.tabs)

    def __getattr__(self, name):
        ti = _TABLE_INDEX.get(name)
        if ti is not None and "_host_tabs" in self.__dict__:
            return self.__dict__["_host_tabs"][ti]
        raise AttributeError(name)


# Scatter-element floor below which auto mode keeps a group off the K5
# add-back (the JAX package's TPU DMA cost floor).
_PALLAS_MIN_ELEMENTS = 1 << 20

# Add-back (K4) budgets of the JAX package: the whole factor value array
# and the padded sheared-delta block together in the TPU's scoped VMEM.
_VMEM_LVALS_BUDGET = 60 * 2**20          # nnz_l * 4 bytes
_VMEM_PSH_BUDGET = 24 * 2**20            # unpadded St*Wt*col_pad*4 bytes
_VMEM_COL_CLASSES = (512, 2048, 8192)    # col_pad quantisation
_VMEM_CQ_CAP = {512: 1 << 14, 2048: 1 << 12, 8192: 1 << 10}

# Rect-merge temp budget (elements): levels whose one-hot merge temps
# exceed this are merged in U-chunks (see _delta_scatter).
_MERGE_CHUNK_ELEMS = 1 << 27

# Run-read (K3) run-length classes and the run-count cap.
_KREAD_CLASSES = (128, 256, 512, 1024, 2048, 4096, 8192)
_KREAD_CR_CAP = 1 << 17


def _kread_lpad(L: int):
    for c in _KREAD_CLASSES:
        if c >= max(int(L), 1):
            return c
    return None


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _colq(rd: int) -> int:
    """The JAX package's K5 column-row length for a group's rect rows:
    1024-aligned, then rounded up to a power of two (the TPU kernel's DMA
    tiling); its cost model sizes the shear temp with it."""
    return _pow2(-(-rd // 1024) * 1024)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _upd_positions(base, meta, irows, ibelow, jrows, jcp, scratch,
                   build_gathers: bool = True, build_scatter: bool = True):
    """Rebuild the (U, I, W)/(U, J, W)/(U, I, J) update position arrays
    from the compact per-update vectors (int64). Source-panel gathers are
    affine (pos = base[col] + rank); the scatter is affine in-panel and one
    precomputed below-rank otherwise. Padding slots all land on
    ``scratch``."""
    I = irows.shape[1]
    J = jrows.shape[1]
    ii = _arange(I, base)
    jj = _arange(J, base)
    ni = meta[:, 0]
    nj = meta[:, 1]
    his = meta[:, 2]
    ga = gb = sc = None
    if build_gathers:
        vb = base != scratch                                 # (U, W)
        ga = torch.where(
            (ii[None, :, None] < ni[:, None, None]) & vb[:, None, :],
            base[:, None, :] + ii[None, :, None], scratch)
        gb = torch.where(
            (jj[None, :, None] < nj[:, None, None]) & vb[:, None, :],
            base[:, None, :] + jj[None, :, None], scratch)
    if build_scatter:
        ir = irows[:, :, None]                               # (U, I, 1)
        jr = jrows[:, None, :]                               # (U, 1, J)
        cpj = jcp[:, None, :]
        valid = ((ii[None, :, None] < ni[:, None, None])
                 & (jj[None, None, :] < nj[:, None, None])
                 & (ir >= jr))
        in_panel = ir < his[:, None, None]
        pos = torch.where(in_panel, cpj + ir - jr,
                          cpj + (his[:, None, None] - jr)
                          + ibelow[:, :, None])
        sc = torch.where(valid, pos, scratch)
    return ga, gb, sc


def _win(lvals, starts, L: int):
    """Batched contiguous-window gather: ``lvals[s : s + L]`` per start,
    with each start clamped into ``[0, len - L]`` as the JAX package's
    ``dynamic_slice`` does. Returns lvals.shape[:-1] + starts.shape + (L,)
    (a batched ``lvals`` (Bt, N) reads every system at the same starts)."""
    s = starts.clamp(0, max(lvals.shape[-1] - L, 0))
    return lvals[..., s[..., None] + _arange(L, starts)]


def _win_k(lvals, starts, L: int, kread):
    """Run reads through the K3 kernel when the matrix has a class for this
    run length (``kread`` is the schedule's class table) and the run count
    is within the cap; plain windows otherwise. The cap counts one system's
    runs: a batch reads through K3 exactly where one system does, in one
    launch (the kernel takes the batch on its grid and has no limit of its
    own on the runs of a launch; the cap is the JAX package's TPU budget,
    kept for the routing)."""
    if kread:
        lp = _kread_lpad(L)
        u, w = starts.shape
        if lp is not None and u * w <= _KREAD_CR_CAP:
            from ..ops.pallas.runs_read import win_kernel

            return win_kernel(lvals, starts, L, lp)
    return _win(lvals, starts, L)


def _upd_windows(lvals, base, meta, scratch, I: int, J: int, kread=()):
    """Window form of the update reads (A, B operands of the level
    product). Lanes beyond each update's (ni, nj) or on padded columns are
    masked to zero."""
    ni = meta[:, 0]
    nj = meta[:, 1]
    vb = base != scratch
    ii = _arange(I, base)
    jj = _arange(J, base)
    sbase = torch.where(vb, base, -1)    # dead runs; masked below
    A = _win_k(lvals, sbase, I, kread).transpose(-2, -1)    # (U, I, W)
    A = torch.where((ii[None, :, None] < ni[:, None, None])
                    & vb[:, None, :], A, 0.0)
    B = _win_k(lvals, sbase, J, kread).transpose(-2, -1)    # (U, J, W)
    B = torch.where((jj[None, :, None] < nj[:, None, None])
                    & vb[:, None, :], B, 0.0)
    return A, B


def _panel_windows(lvals, cp, tv, r_tab, R: int, kread=()):
    """Window form of the panel reads (top triangle + below block).
    T[s, i, j] = lvals[cp[s, j] + i - j] → per-(s, j) window at cp - j;
    B[s, r, j] = lvals[cp[s, j] + w_s - j + r] → window at cp + w_s - j."""
    S, W = cp.shape
    il = _arange(W, cp)
    w = tv.sum(dim=-1)
    T = _win_k(lvals, cp - il[None, :], W, kread).transpose(-2, -1)
    tri = tv[:, :, None] & tv[:, None, :] & (
        il[:, None] >= il[None, :])[None]
    T = torch.where(tri, T, 0.0)
    Bp = _win_k(lvals, cp + w[:, None] - il[None, :], R,
                kread).transpose(-2, -1)                     # (S, R, W)
    bmask = tv[:, None, :] & (_arange(R, cp)[None, :, None]
                              < r_tab[:, None, None])
    Bp = torch.where(bmask, Bp, 0.0)
    return T, Bp


def _panel_positions(cp, r_tab, tv, R, scratch):
    """Rebuild the (S, W, W) top-triangle and (S, R, W) below-block
    position arrays from per-panel col_ptr vectors (affine in both
    ranks)."""
    S, W = cp.shape
    il = _arange(W, cp)
    rr = _arange(R, cp)
    w = tv.sum(dim=-1)                                       # (S,)
    tri_mask = tv[:, :, None] & tv[:, None, :] & (
        il[:, None] >= il[None, :])[None]
    tp = torch.where(tri_mask, cp[:, None, :] + (il[:, None] - il[None, :]),
                     scratch)
    bp_mask = tv[:, None, :] & (rr[None, :, None] < r_tab[:, None, None])
    bp = torch.where(bp_mask,
                     cp[:, None, :] + (w[:, None, None] - il[None, None, :])
                     + rr[None, :, None],
                     scratch)
    return tp, bp


def supernode_stats(a: CSR, *, relax: int = 0):
    """Cheap partition-only analysis — enough to decide the supernodal tier
    without building the full schedule. Returns ``(avg_panel_width,
    parts)``, memoised per (matrix, relax); ``parts`` carries what
    :func:`analyze_supernodal` needs: (parent, col_ptr, csc_rows, sid, c0,
    c1)."""
    check(a.rows == a.cols, NonSquareMatrix, f"needs square, got {a.dims}")
    cache = getattr(a, "_sn_stats_cache", None)
    if cache is not None and cache[0] == relax:
        return cache[1], cache[2]
    n = a.rows
    parent, l_indptr, l_indices = symbolic.chol_symbolic_csr(a)

    # CSC pattern, diagonal first per column.
    l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
    order = np.lexsort((l_rows, l_indices))
    csc_rows = l_rows[order]
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(col_ptr[1:], l_indices[order], 1)
    col_ptr = np.cumsum(col_ptr)

    sid = symbolic.supernodes(col_ptr, csc_rows, parent, relax=relax)
    nsn = int(sid.max()) + 1 if n else 0
    # sid is non-decreasing: supernode column ranges by binary search
    c0 = np.searchsorted(sid, np.arange(nsn))
    c1 = np.searchsorted(sid, np.arange(nsn), side="right")
    width = n / max(nsn, 1)
    parts = (parent, col_ptr, csc_rows, sid, c0, c1)
    a._sn_stats_cache = (relax, width, parts)
    return width, parts


def analyze_supernodal(a: CSR, *, relax: int = 0) -> SupernodalSchedule:
    """Host analysis: the supernodal schedule of ``a`` with its tables on
    ``a``'s device. ``relax > 0`` amalgamates near-identical columns into
    wider panels by expanding the factor pattern with explicit zeros (every
    column of a supernode takes the union row structure). With the
    fundamental property restored, every column of a panel is exactly
    ``[tail | below]`` sorted ascending, so all gather and panel positions
    are affine in (column, rank); only the update scatter needs a
    ``searchsorted`` into the target panel's below rows."""
    _, parts = supernode_stats(a, relax=relax)
    parent, col_ptr, csc_rows, sid, c0, c1 = parts
    n = a.rows
    nsn = c0.shape[0]
    indptr, indices, values = a.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))

    if relax > 0:
        # native pattern expansion (explicit zeros restore the fundamental
        # property); sid/c0/c1 are unchanged by construction
        col_ptr, csc_rows = symbolic.expand_pattern(
            n, col_ptr, csc_rows, c0, c1)
    csc_cols = np.repeat(np.arange(n), np.diff(col_ptr))
    nnz_l = csc_rows.shape[0]
    csc_keys = csc_cols * n + csc_rows

    # A scatter positions (lower incl diagonal) — AFTER any pattern
    # expansion so positions index the final value array.
    keep = indices <= rows
    # indices may be int32 from CSR storage: the key must widen BEFORE the
    # multiply (int32*n overflows at n > 65535 under NumPy-2 promotion).
    a_src_pos = np.searchsorted(
        csc_keys, indices[keep].astype(np.int64) * n + rows[keep])
    a_vals_idx = np.nonzero(keep)[0]

    # supernode etree + fan-in levels
    last_parent = parent[c1 - 1] if nsn else np.empty(0, dtype=np.int64)
    sparent = np.where(last_parent != -1,
                       sid[np.clip(last_parent, 0, max(n - 1, 0))], -1)
    slevel = np.zeros(nsn, dtype=np.int64)
    for s in range(nsn):       # sparent[s] > s: one ascending pass suffices
        p = sparent[s]
        if p != -1:
            slevel[p] = max(slevel[p], slevel[s] + 1)
    nlev = int(slevel.max()) + 1 if nsn else 1
    scratch = nnz_l
    w_of = (c1 - c0).astype(np.int64)

    # ---------------- update lists, grouped by target level ----------------
    # Update gather positions are affine: within source panel d, column
    # c's rows are [c..hi) ++ below_d, so pos(below_d[r], c) =
    # col_ptr[c] + (hi - c) + r.
    updates: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(nlev)]
    for d in range(nsn):
        last = int(c1[d]) - 1
        rd = csc_rows[col_ptr[last] + 1: col_ptr[last + 1]]
        if rd.size == 0:
            continue
        tgt = sid[rd]
        bounds = np.nonzero(np.diff(tgt))[0] + 1
        g0s = np.concatenate([[0], bounds])
        g1s = np.concatenate([bounds, [rd.size]])
        for g0, g1 in zip(g0s, g1s):
            s = int(tgt[g0])
            updates[int(slevel[s])].append((d, int(g0), int(g1), s))

    # ---- bucket each level's updates by shape class (padding bound) ----
    # Under ND orderings a level mixes many leaf updates with a few
    # separator updates 10-100x their size; one padded (U, maxI, maxJ, W)
    # stack then charges every small update the big updates' dims — in
    # table memory, upload bytes, AND einsum flops (padding multiplies
    # real zeros). Bucket updates by the pow4 class of their I-dim into at
    # most _MAX_BUCKETS stacks per level; every bucket except the one
    # carrying the level's panel finalisation becomes an update-only
    # pseudo-level (dummy 1x1 panel tables aimed at the scratch slot, which
    # the numeric step re-zeroes anyway).
    def _upd_dims(up):
        d, g0, g1, _ = up
        last = int(c1[d]) - 1
        nrd = int(col_ptr[last + 1] - col_ptr[last] - 1)
        return nrd - g0, g1 - g0, int(w_of[d])

    def _stack_volume(ups):
        if not ups:
            return 0
        dims = [_upd_dims(up) for up in ups]
        mi = max(d[0] for d in dims)
        mj = max(d[1] for d in dims)
        mw = max(d[2] for d in dims)
        return len(ups) * (mi * mw + mj * mw + mi * mj)

    entries: List[Tuple[list, int]] = []   # (updates, panel level | -1)
    for lv in range(nlev):
        ups = updates[lv]
        buckets: dict = {}
        for up in ups:
            i_dim = max(_upd_dims(up)[0], 1)
            cls = 0
            while (1 << (2 * cls)) < i_dim:   # classes at 1, 4, 16, 64, …
                cls += 1
            buckets.setdefault(cls, []).append(up)
        classes = sorted(buckets)
        while len(classes) > _MAX_BUCKETS:    # merge the two smallest
            buckets[classes[1]] = buckets.pop(classes[0]) + buckets[classes[1]]
            classes = sorted(buckets)
        # split only when the single stack genuinely over-pads: bucketing a
        # homogeneous level just fragments the same-shape groups
        v1 = _stack_volume(ups)
        v2 = sum(_stack_volume(buckets[c]) for c in classes)
        if len(classes) <= 1 or v1 <= 2 * v2 or v1 < _BUCKET_MIN_VOLUME:
            entries.append((ups, lv))
        else:
            for ci, cls in enumerate(classes):
                entries.append((buckets[cls],
                                lv if ci == len(classes) - 1 else -1))

    # Compact per-update vectors only (O(I+J+W) per update, not O(I·(J+W)));
    # the full position arrays are rebuilt per level by _upd_positions.
    upd_base, upd_meta = [], []
    upd_irows, upd_ibelow, upd_jrows, upd_jcp = [], [], [], []
    tgt_cp, tgt_nrows, tgt_w, upd_seg = [], [], [], []
    delta_rmax, use_delta, use_pallas, use_window = [], [], [], []
    vm_fit, vm_win, vm_cols, vm_colneed = [], [], [], []
    for ei, (ups, _panel_lv) in enumerate(entries):
        # Sort updates by target panel: the delta formulation's segment
        # merge wants runs, and update order within a level is arbitrary
        # (all sources live in earlier levels).
        ups = sorted(ups, key=lambda up: up[3])
        entries[ei] = (ups, _panel_lv)
        U = max(len(ups), 1)
        maxI = maxJ = maxWl = 1
        for d, g0, g1, s in ups:
            last = int(c1[d]) - 1
            nrd = int(col_ptr[last + 1] - col_ptr[last] - 1)
            maxI = max(maxI, nrd - g0)
            maxJ = max(maxJ, g1 - g0)
            maxWl = max(maxWl, int(w_of[d]))
        baset = np.full((U, maxWl), scratch, dtype=np.int64)
        metat = np.zeros((U, 4), dtype=np.int64)
        irt = np.full((U, maxI), n, dtype=np.int64)
        ibt = np.zeros((U, maxI), dtype=np.int64)
        jrt = np.full((U, maxJ), n, dtype=np.int64)
        jct = np.full((U, maxJ), scratch, dtype=np.int64)
        for u, (d, g0, g1, s) in enumerate(ups):
            lo, hi = int(c0[d]), int(c1[d])
            wd = hi - lo
            last = hi - 1
            rd = csc_rows[col_ptr[last] + 1: col_ptr[last + 1]]
            ni, nj = rd.size - g0, g1 - g0
            cols_d = np.arange(lo, hi)
            baset[u, :wd] = col_ptr[cols_d] + (hi - cols_d) + g0
            # scatter metadata: pos(i, j) for i >= j; i in rd[g0:], j in
            # rd[g0:g1] (j are columns of target panel s). Column j's rows
            # are [j..hi_s) ++ below_s → in-panel targets are affine,
            # below-panel targets need one searchsorted into below_s.
            hi_s = int(c1[s])
            last_s = hi_s - 1
            below_s = csc_rows[col_ptr[last_s] + 1: col_ptr[last_s + 1]]
            i_rows = rd[g0:]
            j_rows = rd[g0:g1]
            metat[u] = (ni, nj, hi_s, int(c0[s]))
            irt[u, :ni] = i_rows
            ibt[u, :ni] = np.searchsorted(below_s, i_rows)
            jrt[u, :nj] = j_rows
            jct[u, :nj] = col_ptr[j_rows]
        upd_base.append(baset.astype(np.int32))
        upd_meta.append(metat.astype(np.int32))
        # Row ids and below-ranks are < n (sentinel exactly n), so the host
        # tables hold them as uint16 whenever n fits, as in the JAX package;
        # they are widened to int32 before the upload. base/jcp index the
        # nnz_l-sized value array: int32.
        row_dtype = np.uint16 if n <= 0xFFFF else np.int32
        upd_irows.append(irt.astype(row_dtype))
        upd_ibelow.append(ibt.astype(row_dtype))
        upd_jrows.append(jrt.astype(row_dtype))
        upd_jcp.append(jct.astype(np.int32))

        # -------- target-panel tables (delta-scatter formulation) --------
        # The level's distinct update targets; each target panel's storage
        # is one contiguous dense trapezoid whose (row rank r, col rank w)
        # element sits at col_ptr[c0_s + w] + (r - w) — affine for tail AND
        # below rows. Embedding every update into its target's rect via
        # one-hot products and scattering the merged rects replaces the
        # U·I·J element scatter with St·nrows·Wt (see _level_step).
        ts = sorted({s for _, _, _, s in ups})
        St = max(len(ts), 1)
        Wt = max((int(w_of[s]) for s in ts), default=1)
        nrows_of = {}
        for s in ts:
            hi_s = int(c1[s])
            below_ct = int(col_ptr[hi_s] - col_ptr[hi_s - 1] - 1)
            nrows_of[s] = int(w_of[s]) + below_ct
        rmax_d = max(nrows_of.values(), default=1)
        tcp = np.full((St, Wt), scratch, dtype=np.int64)
        tnr = np.zeros((St,), dtype=np.int64)
        twd = np.zeros((St,), dtype=np.int64)
        for k, s in enumerate(ts):
            lo_s, hi_s = int(c0[s]), int(c1[s])
            ws = hi_s - lo_s
            tcp[k, :ws] = col_ptr[lo_s:hi_s]
            tnr[k] = nrows_of[s]
            twd[k] = ws
        rank_of = {s: k for k, s in enumerate(ts)}
        segt = np.zeros((U,), dtype=np.int64)
        for u, (_, _, _, s) in enumerate(ups):
            segt[u] = rank_of[s]
        tgt_cp.append(tcp.astype(np.int32))
        tgt_nrows.append(tnr.astype(np.int32))
        tgt_w.append(twd.astype(np.int32))
        upd_seg.append(segt.astype(np.int32))
        delta_rmax.append(max(rmax_d, 1))
        # Host formulation choice: the JAX package's TPU cost model (a
        # per-element scatter at ~10 ns, one-hot merges nearly free, a
        # window issue at ~0.8 us, a DMA pair at ~2-3 us), kept constant
        # for constant so that every group takes the JAX package's
        # formulation; unmeasured on the H100.
        elem_scatter = U * maxI * maxJ
        rect_scatter = St * rmax_d * Wt
        # Memory guard over every delta-formulation intermediate: the merge
        # temps d (U·I·Wt) / e (U·Rd·Wt), the merged rects p (St·Rd·Wt).
        delta_elems = max(U * maxI * rmax_d, U * maxI * Wt,
                          U * rmax_d * Wt, St * rmax_d * Wt)
        rowmap_mb = delta_elems * 4 / 2**20
        # The JAX package's K5 shear temp at the padded shape it allocates:
        # (pow2(St), pow2(Wt), colq(Rd) + 1024).
        shear_mb = (_pow2(St) * _pow2(Wt)
                    * (_colq(rmax_d) + 1024)) * 4 / 2**20
        # K5 (auto): more than ~300 scatter elements per live column, and
        # above the _PALLAS_MIN_ELEMENTS floor.
        live_cols = sum(int(w_of[s]) for s in ts)
        use_pallas.append(bool(ups) and rowmap_mb < 1024
                          and shear_mb < 1024
                          and min(elem_scatter, rect_scatter)
                          > _PALLAS_MIN_ELEMENTS
                          and live_cols * 300
                          < min(elem_scatter, rect_scatter))
        # Rect scatter: fewer scatter elements by a 1.2 margin.
        use_delta.append(bool(ups) and rect_scatter * 1.2 < elem_scatter
                         and rowmap_mb < 1024)
        # Window reads (auto, without K3 classes): runs of I+J >= 144.
        use_window.append(bool(ups) and maxI + maxJ >= 144)
        # K4 candidate: kernel column loop + the factor/psh transfer (+ the
        # merge einsums where the incumbent was element mode) against the
        # incumbent's scatter elements. Shapes are class-quantized after
        # grouping.
        col_need = -(-(rmax_d + 1) // 128) * 128 + 128
        vm_c = St * Wt
        einsum_macs = (U * maxI * maxJ * Wt + U * maxI * rmax_d * Wt
                       + St * U * rmax_d * Wt)
        kern_s = vm_c * (col_need // 128) * 8 * 1.06e-9
        dma_s = (nnz_l * 8 + vm_c * col_need * 4) / 700e9
        # One-hot merge rate: 2e13 MAC/s.
        extra_s = 0.0 if (use_pallas[-1] or use_delta[-1]) \
            else einsum_macs / 2e13
        incumbent_s = (rect_scatter
                       if (use_pallas[-1] or use_delta[-1])
                       else elem_scatter) * 10e-9
        # No rowmap temp gate here: _delta_scatter merges in U-chunks when
        # the merge temps exceed _MERGE_CHUNK_ELEMS.
        temps_ok = (St * Wt * (col_need + Wt) * 4 < 2**30
                    and vm_c * col_need * 4 <= _VMEM_PSH_BUDGET)
        vm_fit.append(bool(ups) and temps_ok and col_need <= 8192)
        vm_win.append(use_pallas[-1]
                      or (kern_s + dma_s + extra_s) * 1.2 < incumbent_s)
        vm_cols.append(vm_c)
        vm_colneed.append(col_need)

    # ------------- panel tables (compact: col_ptr vectors) -------------
    panel_cp, panel_r, top_valid = [], [], []
    for _ups, lv in entries:
        if lv == -1:
            # update-only pseudo-level: dummy panels into the scratch slot
            panel_cp.append(np.full((1, 1), scratch, dtype=np.int32))
            panel_r.append(np.zeros((1,), dtype=np.int32))
            top_valid.append(np.zeros((1, 1), dtype=bool))
            continue
        sns = np.nonzero(slevel == lv)[0]
        S = max(sns.size, 1)
        Wl = max((int(w_of[s]) for s in sns), default=1)
        cp = np.full((S, Wl), scratch, dtype=np.int64)
        rt = np.zeros((S,), dtype=np.int64)
        tv = np.zeros((S, Wl), dtype=bool)
        for k, s in enumerate(sns):
            lo, hi = int(c0[s]), int(c1[s])
            w = hi - lo
            tv[k, :w] = True
            cp[k, :w] = col_ptr[lo:hi]
            rt[k] = int(col_ptr[hi] - col_ptr[hi - 1] - 1)
        panel_cp.append(cp.astype(np.int32))
        panel_r.append(rt.astype(np.int32))
        top_valid.append(tv)

    # Group consecutive levels whose table shapes, max below-row counts and
    # routing all match, and stack them (leading axis g), as the JAX
    # package does.
    per_level = [upd_base, upd_meta, upd_irows, upd_ibelow, upd_jrows,
                 upd_jcp, panel_cp, panel_r, top_valid,
                 tgt_cp, tgt_nrows, tgt_w, upd_seg]
    rmax = [int(r.max()) if r.size else 0 for r in panel_r]
    grouped = [[] for _ in per_level]
    _group_starts = []
    nent = len(entries)
    lv = 0
    while lv < nent:
        _group_starts.append(lv)
        j = lv + 1
        while (j < nent and rmax[j] == rmax[lv]
               and delta_rmax[j] == delta_rmax[lv]
               and use_delta[j] == use_delta[lv]
               and use_pallas[j] == use_pallas[lv]
               and vm_fit[j] == vm_fit[lv] and vm_win[j] == vm_win[lv]
               and all(t[j].shape == t[lv].shape for t in per_level)):
            j += 1
        for gl, t in zip(grouped, per_level):
            gl.append(np.stack(t[lv:j]))
        lv = j

    # ---- K4 shape classes (1-3 per matrix) ----
    # col_pad classes are fixed; CQ (flattened column-slot count) is the
    # pow2 max over the class's groups, so every group in a class shares one
    # shape. The factor-size gate (_VMEM_LVALS_BUDGET) disables the path
    # for large factors, as in the JAX package.
    lvals_fit = nnz_l * 4 <= _VMEM_LVALS_BUDGET
    g_class = []
    cls_max_cols: dict = {}
    for lv in _group_starts:
        cc = None
        if lvals_fit and vm_fit[lv]:
            cc = next((c for c in _VMEM_COL_CLASSES
                       if c >= vm_colneed[lv]
                       and vm_cols[lv] <= _VMEM_CQ_CAP[c]), None)
        g_class.append(cc)
        if cc is not None:
            cls_max_cols[cc] = max(cls_max_cols.get(cc, 1), vm_cols[lv])
    cls_cq = {cc: _pow2(m) for cc, m in cls_max_cols.items()}
    vmem_shape = tuple((cls_cq[cc], cc) if cc is not None else None
                       for cc in g_class)
    # Auto-route only groups whose own (cols x col_need) footprint is
    # within 8x of the class shape.
    def _pad_ok(cc, lv):
        return (cls_cq[cc] * cc
                <= 8 * max(vm_cols[lv] * vm_colneed[lv], 1))
    use_vmem = tuple(cc is not None and vm_win[lv] and _pad_ok(cc, lv)
                     for cc, lv in zip(g_class, _group_starts))

    # ---- run-read (K3) classes ----
    # Every read in the numeric phase is a contiguous run whose length is
    # a table shape: A runs of I, B runs of J, panel-top runs of Wl,
    # below-block runs of R — with U*W / S*Wl runs each. Collect the
    # (run-length class -> max run count) table.
    kread_needs: dict = {}
    if lvals_fit:
        for gi in range(len(grouped[0])):
            _, U_, W_ = grouped[0][gi].shape      # upd_base (g, U, W)
            I_ = grouped[2][gi].shape[2]          # upd_irows (g, U, I)
            J_ = grouped[4][gi].shape[2]          # upd_jrows (g, U, J)
            _, S_, Wl_ = grouped[6][gi].shape     # panel_cp (g, S, Wl)
            R_ = max(rmax[_group_starts[gi]], 1)
            for L_, cr in ((I_, U_ * W_), (J_, U_ * W_),
                           (Wl_, S_ * Wl_), (R_, S_ * Wl_)):
                lp = _kread_lpad(L_)
                if lp is not None and cr <= _KREAD_CR_CAP:
                    kread_needs[lp] = max(kread_needs.get(lp, 256), cr)
    kread = tuple(sorted((lp, max(_pow2(m), 256))
                         for lp, m in kread_needs.items()))

    dev = a.device

    def _upload(t: np.ndarray) -> torch.Tensor:
        # uint16 row tables widen to int32 on the host before the upload.
        return to_tensor(t.astype(np.int32) if t.dtype == np.uint16 else t,
                         dev)

    tabs = tuple(tuple(_upload(grouped[ti][gi]) for ti in range(len(grouped)))
                 for gi in range(len(grouped[0])))
    return SupernodalSchedule(
        a_src_pos=to_tensor(a_src_pos.astype(np.int64), dev),
        a_vals_idx=to_tensor(a_vals_idx.astype(np.int64), dev),
        tabs=tabs,
        panel_rmax=tuple(max(rmax[lv], 1) for lv in _group_starts),
        delta_rmax=tuple(delta_rmax[lv] for lv in _group_starts),
        use_delta=tuple(use_delta[lv] for lv in _group_starts),
        use_pallas=tuple(use_pallas[lv] for lv in _group_starts),
        vmem_shape=vmem_shape,
        use_vmem=use_vmem,
        kread=kread,
        use_window=tuple(use_window[lv] for lv in _group_starts),
        nnz_l=nnz_l,
        n=n,
        _host_tabs=tuple(tuple(gl) for gl in grouped),
        avg_panel_width=n / max(nsn, 1),
        l_pattern=(csc_rows, csc_cols),
    )


def _delta_scatter(lvals, u3, meta, irows, ibelow, jrows,
                   tcp, tnr, twd, seg, Rd: int,
                   scratch: int, mode: str = "delta"):
    """Apply a level's updates as target-panel rect deltas instead of
    per-element scatters. Each target panel's storage is one contiguous
    trapezoid whose (row rank r, col rank w) element sits at
    ``col_ptr[c0_s + w] + (r - w)`` for tail and below rows, so:

    * embed every update into its target's (Rd, Wt) rect with two one-hot
      products (row rank ``ir - c0_s`` in the tail, ``W_s + ibelow``
      below; col rank ``jr - c0_s``) — values copied exactly in float32;
    * merge updates sharing a target with a one-hot segment product
      (in U-chunks when the temps would exceed ``_MERGE_CHUNK_ELEMS``);
    * ``mode="delta"``: scatter the St merged rects at affine positions;
    * ``mode="rects"``: hand the merged rects to the add-back
      (``ops/pallas/addback_resident.addback_rects``: the rect entry of
      ``csrc/addback.cu`` on a CUDA tensor, which shears, negates and masks
      as it reads; its plain composition on a CPU tensor).

    Out-of-range ranks (padding lanes, upper wedge) fall out of the one-hot
    support or land on ``scratch``, which the caller re-zeroes. Both modes
    update ``lvals`` in place. The merge is :func:`_merge_rects`, the
    add-back :func:`_apply_rects` (the distributed factorization sums the
    ranks' merged rects between the two). A batch (``lvals`` (Bt, N),
    ``u3`` (Bt, U, I, J)) runs every step once for all systems."""
    St, Wt = tcp.shape
    p = _merge_rects(u3, meta, irows, ibelow, jrows, seg, St, Rd, Wt)
    return _apply_rects(lvals, p, tcp, tnr, twd, scratch, mode)


def _merge_rects(u3, meta, irows, ibelow, jrows, seg, St: int, Rd: int,
                 Wt: int) -> torch.Tensor:
    """Embed each update ``u3`` (U, I, J) into its target's (Rd, Wt) rect
    and merge the updates of one target (``seg`` indexes the level's
    target table): the (St, Rd, Wt) rects, not negated; (Bt, St, Rd, Wt)
    for a batch ``u3`` (Bt, U, I, J), the one-hot maps shared."""
    Ucnt, I, J = u3.shape[-3:]
    bt = math.prod(u3.shape[:-3])
    dt = u3.dtype
    ni, nj, his, c0s = (meta[:, 0], meta[:, 1], meta[:, 2], meta[:, 3])
    ii = _arange(I, u3)
    jj = _arange(J, u3)
    ws = his - c0s                                           # (U,)
    ri = torch.where(irows < his[:, None], irows - c0s[:, None],
                     ws[:, None] + ibelow)
    ri = torch.where(ii[None, :] < ni[:, None], ri, Rd)      # (U, I)
    rj = torch.where(jj[None, :] < nj[:, None],
                     jrows - c0s[:, None], Wt)               # (U, J)

    def merge_chunk(u3c, ric, rjc, sgc):
        rowmap = (ric[:, :, None] == _arange(Rd, u3)).to(dt)  # (u, I, Rd)
        colmap = (rjc[:, :, None] == _arange(Wt, u3)).to(dt)  # (u, J, Wt)
        segmap = (sgc[None, :] == _arange(St, u3)[:, None]).to(dt)
        d = torch.einsum("...uij,ujw->...uiw", u3c, colmap)
        e = torch.einsum("uir,...uiw->...urw", rowmap, d)
        return torch.einsum("su,...urw->...srw", segmap, e)

    # Bound the merge temps (rowmap (U,I,Rd) / d (U,I,Wt) / e (U,Rd,Wt),
    # the last two per system) by merging U-chunks when the level is too
    # big to merge at once; the batch counts in the bound.
    per_u = max(I * Rd, I * Wt, Rd * Wt, I * J) * bt
    uc = max(min(_MERGE_CHUNK_ELEMS // max(per_u, 1), Ucnt), 1)
    if uc < Ucnt:
        p = torch.zeros(u3.shape[:-3] + (St, Rd, Wt), dtype=dt,
                        device=u3.device)
        for u0 in range(0, Ucnt, uc):
            sl = slice(u0, u0 + uc)
            p = p + merge_chunk(u3[..., sl, :, :], ri[sl], rj[sl], seg[sl])
    else:
        p = merge_chunk(u3, ri, rj, seg)
    return p


def _apply_rects(lvals, p, tcp, tnr, twd, scratch: int, mode: str):
    """Subtract the merged rects ``p`` (St, Rd, Wt) from their panels'
    storage by ``mode`` ("delta" or "rects", as :func:`_delta_scatter`
    describes); in place. A batch (``lvals`` (Bt, N), ``p`` (Bt, St, Rd,
    Wt)) in one pass: the delta route adds along the last axis, so each
    system parks its masked elements on its own scratch slot."""
    if mode == "rects":
        from ..ops.pallas.addback_resident import addback_rects

        return addback_rects(lvals, p, tcp, tnr, twd)
    Rd, Wt = p.shape[-2:]
    rr = _arange(Rd, p)[None, :, None]
    wwt = _arange(Wt, p)[None, None, :]
    mask = ((wwt < twd[:, None, None]) & (rr >= wwt)
            & (rr < tnr[:, None, None]))
    pos = torch.where(mask, tcp[:, None, :] + rr - wwt, scratch)
    return lvals.index_add_(-1, pos.reshape(-1),
                            (-p).reshape(*lvals.shape[:-1], -1))


def _nan_failed(lt: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Fill the factors of the batch members whose Cholesky failed with
    NaN, as ``jnp.linalg.cholesky`` returns for a matrix that is not
    positive definite; ``info`` has the leading shape of ``lt`` (panels, or
    systems × panels), so a failure marks its own panel only. (A panel that
    already holds a NaN, from an earlier failed panel, also counts as failed
    here; the JAX package's CPU Cholesky lets such a NaN propagate from its
    pivot on instead. The NaN positions of the factor agree; finite values
    of such panels may not.)"""
    return torch.where((info != 0)[..., None, None],
                       torch.full((), float("nan"), dtype=lt.dtype,
                                  device=lt.device), lt)


def _update_products(lvals, base, meta, irows, ibelow, jrows, jcp,
                     scratch: int, window: bool, kread=()) -> torch.Tensor:
    """The batched panel-outer-product updates ``L_d[I,:] @ L_d[J,:]ᵀ`` of
    the given update tables: (U, I, J), or (Bt, U, I, J) for a batched
    ``lvals``."""
    I = irows.shape[1]
    J = jrows.shape[1]
    if window:
        A, B = _upd_windows(lvals, base, meta, scratch, I, J, kread)
    else:
        ga, gb, _ = _upd_positions(base, meta, irows, ibelow, jrows, jcp,
                                   scratch, build_scatter=False)
        A = lvals[..., ga]                     # (U, I, W)
        B = lvals[..., gb]                     # (U, J, W)
    return torch.einsum("...uiw,...ujw->...uij", A, B)


def _panel_reads(lvals, cp, r_tab, tv, R: int, tp, bp, window: bool,
                 kread=()):
    """The panels' top triangles (S, W, W) and below blocks (S, R, W), as
    windows or through the positions ``tp``/``bp``."""
    if window:
        return _panel_windows(lvals, cp, tv, r_tab, R, kread)
    return lvals[..., tp], lvals[..., bp]


def _panel_factors(T, Bp, tv):
    """Batched panel finalisation: the top triangles' Cholesky factors
    (non-finite entries zeroed, NaN for a failed panel) and the below
    blocks solved against them. ``T`` (S, W, W) and ``Bp`` (S, R, W), or
    with a leading batch axis (Bt, S, ...) factored as one batch."""
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    # make padded columns well-posed: unit diagonal, zero elsewhere
    Tsym = T + torch.where(tv[:, :, None] & tv[:, None, :], 0.0, eye)
    Lt, info = torch.linalg.cholesky_ex(
        Tsym + torch.triu(Tsym.transpose(-2, -1), 1))
    Lt = _nan_failed(Lt, info)
    # solve Bp_new·Ltᵀ = Bp → Bp_new = Bp·Lt^{-T}
    Bn = torch.linalg.solve_triangular(Lt, Bp.transpose(-2, -1),
                                       upper=False).transpose(-2, -1)
    return torch.where(torch.isfinite(Lt), torch.tril(Lt), 0.0), Bn


def _element_scatter(lvals, U, base, meta, irows, ibelow, jrows, jcp,
                     scratch: int):
    """Subtract the updates ``U`` (U, I, J), or (Bt, U, I, J) from a batched
    ``lvals``, element by element; in place."""
    _, _, sc = _upd_positions(base, meta, irows, ibelow, jrows, jcp,
                              scratch, build_gathers=False)
    return lvals.index_add_(-1, sc.reshape(-1),
                            (-U).reshape(*lvals.shape[:-1], -1))


def _level_step(lvals, tabs, R: int, Rd: int, scratch: int,
                window: bool = False, smode: str = "element", kread=()):
    """One fan-in level: batched panel updates + panel finalisation, on the
    level's compact tables (``top_valid`` bool, the rest int64). With
    ``window=True`` the reads take contiguous runs (through K3 where
    ``kread`` has a class) instead of per-element positions; ``smode``
    routes the update scatter ("element", "delta", "rects").
    Updates ``lvals`` ((N,), or (Bt, N) for a batch) in place and returns
    it."""
    (base, meta, irows, ibelow, jrows, jcp, cp, r_tab, tv,
     tcp, tnr, twd, seg) = tabs
    # 1) batched panel-outer-product updates
    U = _update_products(lvals, base, meta, irows, ibelow, jrows, jcp,
                         scratch, window, kread)
    if smode in ("delta", "rects"):
        lvals = _delta_scatter(lvals, U, meta, irows, ibelow, jrows,
                               tcp, tnr, twd, seg, Rd, scratch, smode)
    else:
        _element_scatter(lvals, U, base, meta, irows, ibelow, jrows, jcp,
                         scratch)
    # fill_, not "= 0.0": assigning a Python float to a CUDA tensor uploads
    # it, a host synchronisation that a graph capture refuses
    lvals[..., scratch].fill_(0.0)

    # 2) batched panel finalisation
    tp, bp = _panel_positions(cp, r_tab, tv, R, scratch)
    T, Bp = _panel_reads(lvals, cp, r_tab, tv, R, tp, bp, window, kread)
    lvals[..., tp], lvals[..., bp] = _panel_factors(T, Bp, tv)
    lvals[..., scratch].fill_(0.0)
    return lvals


_INT_TABLES = tuple(i for i, name in enumerate(_TABLE_NAMES)
                    if name != "top_valid")


def long_tables(sched: SupernodalSchedule) -> Tuple[Tuple[torch.Tensor,
                                                          ...], ...]:
    """Every group's tables as the level step indexes with them (the int32
    ones widened to int64), made once per schedule and kept on it for the
    single-device and the sharded numeric phases. Casting them per call
    put 12 copies a group into every captured numeric phase."""
    cache = sched.__dict__.get("_long_tabs")
    if cache is None:
        cache = sched.__dict__["_long_tabs"] = tuple(
            tuple(t.long() if i in _INT_TABLES else t
                  for i, t in enumerate(tabs)) for tabs in sched.tabs)
    return cache


def _run_group(lvals, tabs, R: int, Rd: int, scratch: int,
               window: bool, smode: str, kread=()):
    """The levels of one group in order (the JAX package's ``lax.scan``),
    on the group's :func:`long_tables`."""
    for li in range(tabs[0].shape[0]):
        lvals = _level_step(lvals, tuple(t[li] for t in tabs), R, Rd,
                            scratch, window, smode, kread)
    return lvals


def _tab_shape(sched: SupernodalSchedule, gi: int, name: str):
    return tuple(sched.tabs[gi][_TABLE_INDEX[name]].shape)


def _win_pad(sched: SupernodalSchedule) -> int:
    """Zero padding past the scratch slot so window reads never clamp into
    live data: the longest window any group issues (kernel-read windows
    extend to the run-length class, + 256 as in the JAX package)."""
    pad = 1
    for gi in range(sched.n_groups):
        pad = max(pad, _tab_shape(sched, gi, "upd_irows")[2],
                  _tab_shape(sched, gi, "upd_jrows")[2],
                  _tab_shape(sched, gi, "panel_cp")[2],
                  sched.panel_rmax[gi])
    if sched.kread:
        pad = max(pad, max(lp for lp, _ in sched.kread) + 256)
    return pad


def _init_lvals(sched: SupernodalSchedule, a_values: torch.Tensor,
                pad: int = 1) -> torch.Tensor:
    """A's lower values (nnz,), or (Bt, nnz), scattered into L's flat CSC
    value array with ``pad`` zeros after it (the scratch slot first)."""
    lvals = torch.zeros(a_values.shape[:-1] + (sched.nnz_l + pad,),
                        dtype=torch.float32, device=a_values.device)
    return lvals.index_add_(-1, sched.a_src_pos,
                            a_values[..., sched.a_vals_idx].to(
                                torch.float32))


def _group_window(sched: SupernodalSchedule, gi: int, window) -> bool:
    """Per-group read formulation under config supernodal_gather:
    True/False ("window"/"element") force one path for every group; "auto"
    takes the host's per-group choice (``use_window``)."""
    if window == "auto":
        return bool(sched.use_window[gi])
    return bool(window)


def _group_read(sched: SupernodalSchedule, gi: int, window):
    """Resolve (window?, kread table) per group. Under "auto" or "kernel",
    when the matrix has run-read classes, every group reads through K3;
    "kernel" without classes reads plain windows."""
    if window in ("auto", "kernel") and sched.kread:
        return True, sched.kread
    if window == "kernel":   # forced but the matrix has no classes
        return True, ()
    return _group_window(sched, gi, window), ()


def _group_delta(sched: SupernodalSchedule, gi: int, mode: str) -> str:
    """Resolve the per-group update route under config supernodal_scatter,
    whose values are the JAX package's names: "element" and "delta" force
    that route; "pallas" sends every group to the add-back ("rects");
    "vmem" sends the groups with a K4 shape class there and takes the auto
    ladder elsewhere; "auto" takes the host's choice (the add-back where
    the JAX package takes K4 or K5, else rect where it wins the element
    count, else element)."""
    if mode in ("element", "delta"):
        return mode
    if mode == "pallas" or (mode == "vmem"
                            and sched.vmem_shape[gi] is not None):
        return "rects"
    if sched.use_vmem[gi] or sched.use_pallas[gi]:
        return "rects"
    return "delta" if sched.use_delta[gi] else "element"


def _needs_win_pad(sched: SupernodalSchedule, window) -> bool:
    if window == "kernel":
        return True
    if window == "auto":
        return any(sched.use_window) or bool(sched.kread)
    return bool(window)


def _read_mode(gather: str):
    """Config supernodal_gather → the read formulation: "auto" and "kernel"
    pass through ("kernel" forces K3 reads, which the JAX package's
    factorize_supernodal maps to element reads), "window" → True, anything
    else → False (element reads)."""
    if gather in ("auto", "kernel"):
        return gather
    return gather == "window"


def _numeric_modes(sched: SupernodalSchedule):
    """(read mode, scatter mode, ``lvals`` length past ``nnz_l``) under the
    current config: the tail padding keeps window reads from clamping into
    live data (the add-back writes live trapezoids only, all inside
    ``nnz_l``)."""
    cfg = get_config()
    window = _read_mode(cfg.supernodal_gather)
    pad = 1 + (_win_pad(sched) if _needs_win_pad(sched, window) else 0)
    return window, cfg.supernodal_scatter, pad


def factorize_supernodal(sched: SupernodalSchedule,
                         a_values: torch.Tensor) -> torch.Tensor:
    """Numeric phase on ``a_values``' device; returns L's flat CSC value
    array (length nnz_l). A Python loop over groups and their levels, every
    product under :func:`matmul_precision`.

    On the card the whole phase (``_init_lvals`` and every group's levels)
    is one captured CUDA graph per schedule, value shape and configuration
    (``runtime/graphs.py``), captured on the second call: the first call on
    a schedule (``DirectSolver``'s own factorization) runs the loop eagerly,
    the second captures and replays it, and every later call replays it
    (the JAX package's jitted ``_factorize_supernodal_whole``). The key
    holds what the recorded program depends on: the read and scatter modes,
    the tail padding, the matmul precision and the deterministic-algorithms
    flag. K3
    and the add-back's rect entry launch inside the graph, so their
    ``LAUNCHES`` move at the capture and not at a replay.

    Config ``supernodal_groups_per_program`` selects nothing here. It bounds
    the size of an XLA program in the JAX package, and a CUDA graph has no
    such limit; cut by it, the 33³ schedule's 263 groups would take 6 graphs
    against ``graphs.MAX_GRAPHS_PER_OWNER`` = 4, which would evict each
    other at every call. It is accepted and changes nothing.

    ``a_values`` of shape (Bt, nnz) factors ``Bt`` matrices of the
    schedule's pattern at once (``jax.vmap`` over the values in the JAX
    package) and returns (Bt, nnz_l): every level runs once for the batch,
    so the kernels launch as often as for one system."""
    if a_values.ndim not in (1, 2):
        raise ValueError(f"factorize_supernodal takes a_values (nnz,) or "
                         f"(Bt, nnz), got {tuple(a_values.shape)}")
    long_tables(sched)
    return graphs.run(sched, numeric_tag(sched),
                      functools.partial(_factorize_whole, sched,
                                        *_numeric_modes(sched)),
                      a_values, capture_on=2)


def numeric_tag(sched: SupernodalSchedule) -> tuple:
    """The graph tag of the numeric phase under the current configuration
    and torch settings."""
    return ("numeric",) + _numeric_modes(sched) + graphs.host_state()


def _factorize_whole(sched: SupernodalSchedule, window, mode: str, pad: int,
                     a_values: torch.Tensor) -> torch.Tensor:
    """The numeric phase as one loop: A's values into ``lvals``, then every
    group's levels in order."""
    scratch = sched.nnz_l
    tables = long_tables(sched)
    with matmul_precision():
        lvals = _init_lvals(sched, a_values, pad)
        for gi in range(sched.n_groups):
            sm = _group_delta(sched, gi, mode)
            win, kr = _group_read(sched, gi, window)
            lvals = _run_group(lvals, tables[gi], sched.panel_rmax[gi],
                               sched.delta_rmax[gi], scratch, win, sm, kr)
    return lvals[..., : sched.nnz_l]


def assemble_factor(a: CSR, lvals, sched: "SupernodalSchedule" = None) -> CSR:
    """Assemble L's CSR from the flat CSC values (host), on ``a``'s
    device."""
    if isinstance(lvals, torch.Tensor):
        lvals = lvals.detach().cpu().numpy()
    if sched is not None and sched.l_pattern is not None:
        csc_rows, csc_cols = sched.l_pattern
    else:
        n = a.rows
        indptr, indices, _ = a.numpy()
        rows = np.repeat(np.arange(n), np.diff(indptr))
        low = indices < rows
        low_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(low_indptr[1:], rows[low], 1)
        low_indptr = np.cumsum(low_indptr)
        _, l_indptr, l_indices = symbolic.chol_symbolic(
            n, low_indptr, indices[low])
        l_rows = np.repeat(np.arange(n), np.diff(l_indptr))
        order = np.lexsort((l_rows, l_indices))
        csc_rows, csc_cols = l_rows[order], l_indices[order]
    if len(lvals) != len(csc_rows):
        raise ValueError(
            f"assemble_factor: lvals length {len(lvals)} does not match the "
            f"factor pattern ({len(csc_rows)} entries) — with an expanded "
            f"(relax > 0) schedule, pass sched so the expanded pattern is "
            f"used")
    return CSR.from_coo_arrays((a.rows, a.rows), csc_rows, csc_cols, lvals,
                               sum_duplicates=False, drop_zeros=False,
                               device=a.device)


def cholesky_supernodal(a: CSR) -> CSR:
    """End-to-end supernodal sparse Cholesky."""
    sched = analyze_supernodal(a)
    return assemble_factor(a, factorize_supernodal(sched, a.values), sched)
