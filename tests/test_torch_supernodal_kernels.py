"""The supernodal kernels' plain versions in the PyTorch port against the JAX
package's Pallas kernels in interpret mode, on the CPU:

* K3 ``runs_read``: unaligned starts, dead slots; only live rows are
  compared (the TPU kernel leaves dead rows unwritten), exactly, since a
  read copies values;
* K4 ``addback_resident`` and K5 ``panel_addback``: unaligned starts, dead
  slots and overlapping spans, to abs 1e-5 (float32 sums of the same terms
  in another order);
* ``shear_reshape``: exactly (a reshape moves values);
* ``addback_rects_reference`` (the plain version of the kernel's rect entry:
  shear, negate, add) against both JAX add-back routes, the ``index_add_``
  of ``supernodal_scatter="delta"`` and a loop; on CPU tensors the
  factorization's add-back modes take the ``"rects"`` route, one
  ``addback_rects`` call a level that the JAX package sends to K4 or K5;
* a Python model of the CUDA span kernel's split (parts, end of run, quads
  on the destination's 16-byte grid) against the plain version.

On a CPU tensor each wrapper runs its plain version and launches nothing;
the CUDA kernels are held against the same plain versions on the card
(``test_torch_cuda_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu.ops.pallas import addback_resident as jk4
from basic_sparse_matrix_tpu.ops.pallas import panel_addback as jk5
from basic_sparse_matrix_tpu.ops.pallas import runs_read as jk3
from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield

ATOL = 1e-5


@pytest.mark.parametrize("nnz,crq,l_pad,seed", [
    (3000, 256, 128, 0), (5000, 512, 256, 1), (2000, 256, 512, 2),
])
def test_runs_read_reference_matches_jax_kernel(nnz, crq, l_pad, seed):
    rng = np.random.default_rng(seed)
    # The JAX kernel needs l_pad + 256 slack past every live start.
    lv = rng.standard_normal(nnz + l_pad + 256).astype(np.float32)
    stf = rng.integers(0, nnz, crq).astype(np.int32)
    stf[::3] = -1
    stf[1::11] = nnz - 1
    want = np.asarray(jk3.runs_read(jnp.asarray(lv), jnp.asarray(stf),
                                    l_pad))
    before = k3.LAUNCHES
    got = k3.runs_read(torch.as_tensor(lv), torch.as_tensor(stf),
                       l_pad).numpy()
    assert k3.LAUNCHES == before
    live = stf >= 0
    assert np.array_equal(got[live], want[live])
    assert not got[~live].any()


@pytest.mark.parametrize("u,w,L,lpad", [(7, 5, 100, 128), (3, 40, 200, 256)])
def test_win_kernel_matches_jax(u, w, L, lpad):
    rng = np.random.default_rng(u * w)
    lv = rng.standard_normal(4000 + lpad + 256).astype(np.float32)
    starts = rng.integers(0, 4000, (u, w)).astype(np.int32)
    starts[0, :2] = -1
    want = np.asarray(jk3.win_kernel(jnp.asarray(lv), jnp.asarray(starts),
                                     L, lpad))
    got = k3.win_kernel(torch.as_tensor(lv), torch.as_tensor(starts), L,
                        lpad).numpy()
    assert got.shape == want.shape == (u, w, L)
    live = starts >= 0
    assert np.array_equal(got[live], want[live])


def _spans(rng, nslots, length, nnz, tail):
    """Rows with a live prefix and >= ``tail`` trailing zeros at random
    (unaligned, often overlapping) starts; every fourth slot dead."""
    rows = np.zeros((nslots, length), np.float32)
    starts = np.full((nslots,), -1, np.int32)
    for c in range(nslots):
        if c % 4 == 3:
            continue
        ln = int(rng.integers(1, length - tail + 1))
        rows[c, :ln] = rng.standard_normal(ln)
        starts[c] = int(rng.integers(0, nnz - 1))
    return rows, starts


@pytest.mark.parametrize("nnz,cq,col_pad,seed", [
    (3000, 16, 256, 5), (2000, 64, 512, 6), (700, 32, 256, 7),
])
def test_addback_resident_reference_matches_jax_kernel(nnz, cq, col_pad,
                                                       seed):
    rng = np.random.default_rng(seed)
    lv = rng.standard_normal(nnz + col_pad).astype(np.float32)
    lv[nnz:] = 0.0
    rows, starts = _spans(rng, cq, col_pad, nnz, 128)
    starts[1] = starts[0] + 3 if starts[0] >= 0 else 5   # overlap
    want = np.asarray(jk4.addback_resident(
        jnp.asarray(lv), jnp.asarray(rows), jnp.asarray(starts)))
    before = k4.LAUNCHES
    got = k4.addback_resident(torch.as_tensor(lv), torch.as_tensor(rows),
                              torch.as_tensor(starts)).numpy()
    assert k4.LAUNCHES == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_addback_resident_is_in_place_and_matches_loop():
    rng = np.random.default_rng(8)
    rows, starts = _spans(rng, 40, 64, 500, 0)
    lv = torch.zeros(600)
    out = k4.addback_resident(lv, torch.as_tensor(rows),
                              torch.as_tensor(starts))
    assert out is lv
    ref = np.zeros(600, np.float64)
    for c in range(40):
        if starts[c] >= 0:
            ref[starts[c]: starts[c] + 64] += rows[c]
    np.testing.assert_allclose(lv.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("st,wt,col_len,seed", [
    (2, 4, 2048, 9), (4, 8, 2048, 10), (1, 3, 3072, 11),
])
def test_panel_addback_reference_matches_jax_kernel(st, wt, col_len, seed):
    rng = np.random.default_rng(seed)
    nnz = 5000
    lv = rng.standard_normal(nnz + col_len + 1024).astype(np.float32)
    lv[nnz:] = 0.0
    rows, flat_starts = _spans(rng, st * wt, col_len, nnz, 1024)
    tcp = np.where(flat_starts >= 0, flat_starts, 0).reshape(st, wt)
    tcp = tcp.astype(np.int32)
    twd = rng.integers(0, wt + 1, st).astype(np.int32)
    psh = rows.reshape(st, wt, col_len)
    want = np.asarray(jk5.panel_addback(
        jnp.asarray(lv), jnp.asarray(psh), jnp.asarray(tcp),
        jnp.asarray(twd)))
    before = k5.LAUNCHES
    got = k5.panel_addback(torch.as_tensor(lv), torch.as_tensor(psh),
                           torch.as_tensor(tcp),
                           torch.as_tensor(twd)).numpy()
    assert k5.LAUNCHES == before
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("st,rd,wt,col_pad", [
    (3, 40, 7, 128), (2, 300, 33, 512), (1, 5, 1, 128),
])
def test_shear_reshape_matches_jax(st, rd, wt, col_pad):
    rng = np.random.default_rng(rd)
    p = np.zeros((st, rd + 10, wt), np.float32)
    p[:, :rd] = rng.standard_normal((st, rd, wt))
    got = k4.shear_reshape(torch.as_tensor(p), col_pad).numpy()
    want = np.asarray(jk4.shear_reshape(jnp.asarray(p), col_pad))
    assert got.shape == want.shape == (st, wt, col_pad)
    assert np.array_equal(got, want)
    s, w, q = np.meshgrid(np.arange(st), np.arange(wt), np.arange(col_pad),
                          indexing="ij")
    r = q + w
    ok = r < rd + 10
    assert np.array_equal(got[ok], p[s[ok], r[ok], w[ok]])
    assert not got[~ok].any()


def test_wrappers_reject_bad_operands():
    lv = torch.zeros(100)
    with pytest.raises(TypeError):
        k3.runs_read(lv, torch.zeros(3, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        k3.runs_read(lv, torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        k4.addback_resident(lv, torch.zeros((2, 8)),
                            torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        k4.addback_resident(lv.double(), torch.zeros((2, 8)),
                            torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        k5.panel_addback(lv, torch.zeros((2, 3, 8)),
                         torch.zeros((2, 4), dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))


# ---- the rect entry's plain version ---------------------------------------
def _rect_operands(seed, st, rd, wt, clean=True):
    """Merged rects with real trapezoid storage: panel s holds tnr[s] rect
    rows and twd[s] live columns, column w stored as its rows w.. in one run,
    the runs laid end to end. ``clean`` zeroes ``p`` outside the live
    trapezoids, as a level's merged rects are; otherwise values stay there
    for the masks to reject."""
    rng = np.random.default_rng(seed)
    tnr = rng.integers(wt, rd + 1, st)
    twd = rng.integers(0, wt + 1, st)
    twd[0] = wt
    tcp = np.zeros((st, wt), np.int64)
    pos = 0
    for s in range(st):
        for w in range(wt):
            tcp[s, w] = pos
            pos += int(tnr[s]) - w
    p = rng.standard_normal((st, rd, wt)).astype(np.float32)
    r = np.arange(rd)[None, :, None]
    w = np.arange(wt)[None, None, :]
    live = (w < twd[:, None, None]) & (r >= w) & (r < tnr[:, None, None])
    if clean:
        p = np.where(live, p, np.float32(0))
    return p, tcp, tnr, twd, live, pos


def _rects_by_loop(lv, p, tcp, live):
    out = lv.astype(np.float64)
    for s, r, w in zip(*np.nonzero(live)):
        out[tcp[s, w] + r - w] -= p[s, r, w]
    return out


RECT_SHAPES = [(0, 3, 40, 7), (1, 5, 150, 33), (2, 1, 9, 1), (3, 12, 64, 16)]


@pytest.mark.parametrize("seed,st,rd,wt", RECT_SHAPES)
def test_addback_rects_reference_matches_the_jax_vmem_route(seed, st, rd, wt):
    """``J.shear_reshape`` -> negate -> pad to the class shape ->
    ``J.addback_resident`` (interpret mode), the JAX package's "vmem" tail,
    on the same operands. rtol 1e-6 (atol 1e-6 of the largest magnitude):
    the same float32 sums, taken in another order where spans overlap."""
    p, tcp, tnr, twd, _, nnz = _rect_operands(seed, st, rd, wt)
    col_pad, cq = 256, 512
    lv = np.random.default_rng(seed + 50).standard_normal(
        nnz + 1 + col_pad).astype(np.float32)
    lv[nnz:] = 0.0
    psh = jk4.shear_reshape(jnp.asarray(-p), col_pad)
    psh2 = jnp.pad(psh.reshape(st * wt, col_pad), ((0, cq - st * wt), (0, 0)))
    wv = np.arange(wt)[None, :]
    tcpf = np.pad(np.where(wv < twd[:, None], tcp, -1).reshape(-1),
                  (0, cq - st * wt), constant_values=-1).astype(np.int32)
    want = np.asarray(jk4.addback_resident(jnp.asarray(lv), psh2,
                                           jnp.asarray(tcpf)))
    before = (k4.LAUNCHES, k5.LAUNCHES)
    for fn in (k4.addback_rects, k4.addback_rects_reference):
        got = fn(torch.as_tensor(lv.copy()), torch.as_tensor(p),
                 torch.as_tensor(tcp), torch.as_tensor(tnr),
                 torch.as_tensor(twd)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
    assert (k4.LAUNCHES, k5.LAUNCHES) == before      # CPU: nothing launched


@pytest.mark.parametrize("seed,st,rd,wt", RECT_SHAPES)
def test_addback_rects_reference_matches_the_jax_pallas_route(seed, st, rd,
                                                              wt):
    """The JAX package's "pallas" tail: the constant one-hot shear, the pads
    to power-of-two panel and column counts with 1024 trailing zeros, then
    ``J.panel_addback`` (interpret mode). Same tolerance."""
    from basic_sparse_matrix_tpu.models import supernodal as jsn

    p, tcp, tnr, twd, _, nnz = _rect_operands(seed, st, rd, wt)
    col_pad = jsn._colq(rd)
    lv = np.random.default_rng(seed + 60).standard_normal(
        nnz + 1 + col_pad + 1024).astype(np.float32)
    lv[nnz:] = 0.0
    shift = (np.arange(rd)[None, None, :]
             == (np.arange(col_pad)[None, :, None]
                 + np.arange(wt)[:, None, None])).astype(np.float32)
    psh = jnp.einsum("wqr,srw->swq", jnp.asarray(shift), jnp.asarray(-p),
                     precision="highest")
    st_q, wt_q = jsn._pow2(st), jsn._pow2(wt)
    psh = jnp.pad(psh, ((0, st_q - st), (0, wt_q - wt), (0, 1024)))
    tcp_q = np.pad(tcp, ((0, st_q - st), (0, wt_q - wt))).astype(np.int32)
    twd_q = np.pad(twd, (0, st_q - st)).astype(np.int32)
    want = np.asarray(jk5.panel_addback(
        jnp.asarray(lv), psh, jnp.asarray(tcp_q), jnp.asarray(twd_q)))
    got = k4.addback_rects_reference(
        torch.as_tensor(lv.copy()), torch.as_tensor(p), torch.as_tensor(tcp),
        torch.as_tensor(tnr), torch.as_tensor(twd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("seed,st,rd,wt", RECT_SHAPES)
def test_addback_rects_reference_masks_like_the_delta_route(seed, st, rd, wt,
                                                            idx):
    """Against ``supernodal_scatter="delta"``'s masked ``index_add_`` and a
    plain loop, with values left OUTSIDE the live trapezoids: the upper
    wedge ``r < w``, rows ``r >= tnr[s]`` and columns ``w >= twd[s]`` must
    add nothing, and the scratch slot, where the delta route parks what it
    masks, must stay as it was."""
    p, tcp, tnr, twd, live, nnz = _rect_operands(seed, st, rd, wt,
                                                 clean=False)
    assert (p[~live] != 0).any()
    scratch = nnz
    lv = np.random.default_rng(seed + 70).standard_normal(
        nnz + 1 + rd).astype(np.float32)
    lv[scratch:] = 0.0
    tp, ttcp, ttnr, ttwd = (torch.as_tensor(p), torch.as_tensor(tcp).to(idx),
                            torch.as_tensor(tnr).to(idx),
                            torch.as_tensor(twd).to(idx))
    got = k4.addback_rects_reference(torch.as_tensor(lv.copy()), tp, ttcp,
                                     ttnr, ttwd)
    rr = torch.arange(rd)[None, :, None]
    ww = torch.arange(wt)[None, None, :]
    mask = (ww < ttwd[:, None, None]) & (rr >= ww) \
        & (rr < ttnr[:, None, None])
    pos = torch.where(mask, ttcp.long()[:, None, :] + rr - ww, scratch)
    want = torch.as_tensor(lv.copy()).index_add_(0, pos.reshape(-1),
                                                 (-tp).reshape(-1))
    assert float(want[scratch]) != 0.0       # the delta route did park there
    assert float(got[scratch]) == 0.0 and not got[scratch:].any()
    assert torch.equal(got[:scratch], want[:scratch])    # one add an element
    np.testing.assert_allclose(got.numpy()[:scratch],
                               _rects_by_loop(lv, p, tcp, live)[:scratch],
                               rtol=0, atol=ATOL)


def test_addback_rects_drops_what_falls_off_and_rejects_bad_operands():
    p = torch.ones((1, 6, 2))
    tcp = torch.tensor([[7, 11]])
    tnr, twd = torch.tensor([6]), torch.tensor([2])
    lv = torch.zeros(10)
    out = k4.addback_rects(lv, p, tcp, tnr, twd)
    assert out is lv
    assert lv.tolist() == [0.0] * 7 + [-1.0] * 3      # column 1 falls off whole
    with pytest.raises(ValueError):
        k4.addback_rects(lv, p, tcp.reshape(2, 1), tnr, twd)
    with pytest.raises(TypeError):
        k4.addback_rects(lv, p, tcp, tnr.to(torch.int32), twd)
    with pytest.raises(TypeError):
        k4.addback_rects(lv, p.double(), tcp, tnr, twd)
    with pytest.raises(TypeError):
        k4.addback_rects(lv, p, tcp.float(), tnr.float(), twd.float())


def _nd_laplacian_2d(k: int):
    """The 5-point Laplacian on a k × k grid, ND-ordered, on the CPU."""
    from basic_sparse_matrix_tpu_torch import CSR
    from basic_sparse_matrix_tpu_torch.ops import reorder

    n = k * k
    d = np.zeros((n, n), np.float32)
    for i in range(n):
        d[i, i] = 4.0
        for j in (i - 1, i + 1, i - k, i + k):
            if 0 <= j < n and not (abs(i - j) == 1 and i // k != j // k):
                d[i, j] = -1.0
    a = CSR.from_dense(d)
    return reorder.permute_symmetric(a, reorder.nd_permutation(a))


def _factorize_under(sn, sched, a, mode):
    from basic_sparse_matrix_tpu_torch.utils import config as cfgmod

    old = cfgmod.get_config()
    cfgmod.set_config(dataclasses.replace(old, supernodal_scatter=mode))
    try:
        return sn.factorize_supernodal(sched, a.values)
    finally:
        cfgmod.set_config(old)


@pytest.mark.parametrize("mode", ["vmem", "pallas"])
def test_delta_scatter_on_a_cpu_tensor_still_shears(monkeypatch, mode):
    """On CPU tensors the add-back modes take the ``"rects"`` route: one
    ``addback_rects`` call a routed level, which runs the rect entry's
    plain composition (shear, negate, span add-back), and never the span
    wrappers that the JAX package's two routes call; the factor is still
    the dense Cholesky's."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    calls = []
    real = k4.addback_rects

    def spy(lvals, p, tcp, tnr, twd):
        assert not lvals.is_cuda
        calls.append(tuple(p.shape))
        return real(lvals, p, tcp, tnr, twd)

    def no_span(*args):
        raise AssertionError("the factorization called a span wrapper")

    monkeypatch.setattr(k4, "addback_rects", spy)
    monkeypatch.setattr(k4, "addback_resident", no_span)
    monkeypatch.setattr(k5, "panel_addback", no_span)
    a = _nd_laplacian_2d(6)
    sched = sn.analyze_supernodal(a, relax=8)
    lvals = _factorize_under(sn, sched, a, mode)
    routed = [gi for gi in range(sched.n_groups)
              if sn._group_delta(sched, gi, mode) == "rects"]
    levels = sum(int(sched.tabs[gi][0].shape[0]) for gi in routed)
    assert levels > 0 and len(calls) == levels
    l = sn.assemble_factor(a, lvals, sched).todense().numpy()
    ref = np.linalg.cholesky(a.todense().numpy().astype(np.float64))
    assert np.allclose(l, ref, rtol=1e-4, atol=1e-4)


def _jax_route(sched, gi, mode):
    """The route of group ``gi`` as the JAX package (and the port before
    its add-back routes became one) picks it: K4 ("vmem"), K5 ("pallas"),
    "delta" or "element"."""
    if mode in ("element", "delta", "pallas"):
        return mode
    if mode == "vmem" and sched.vmem_shape[gi] is not None:
        return "vmem"
    if sched.use_vmem[gi]:
        return "vmem"
    if sched.use_pallas[gi]:
        return "pallas"
    return "delta" if sched.use_delta[gi] else "element"


@pytest.mark.parametrize("mode", ["auto", "vmem", "pallas"])
def test_rects_route_takes_the_levels_of_both_add_back_kernels(monkeypatch,
                                                                mode):
    """The levels routed to ``"rects"`` are exactly those that
    ``use_vmem`` / ``use_pallas`` / ``vmem_shape`` send to K4 or K5 under
    the JAX package's rule, and every other group keeps its route; checked
    on the schedule as analysed and on a copy whose first two groups are
    K5's (a small matrix has no group over K5's element floor), by the
    per-group map and by the rect shapes of the factorization's
    ``addback_rects`` calls, in order."""
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    a = _nd_laplacian_2d(6)
    analysed = sn.analyze_supernodal(a, relax=8)
    g = analysed.n_groups
    swapped = dataclasses.replace(
        analysed, use_vmem=(False, False) + analysed.use_vmem[2:],
        use_pallas=(True, True) + (False,) * (g - 2))
    calls = []
    real = k4.addback_rects

    def spy(lvals, p, tcp, tnr, twd):
        calls.append(tuple(p.shape))
        return real(lvals, p, tcp, tnr, twd)

    monkeypatch.setattr(k4, "addback_rects", spy)
    kernels = set()
    for sched in (analysed, swapped):
        want = [_jax_route(sched, gi, mode) for gi in range(g)]
        got = [sn._group_delta(sched, gi, mode) for gi in range(g)]
        assert got == [m if m in ("element", "delta") else "rects"
                       for m in want]
        kernels |= {m for m in want if m in ("vmem", "pallas")}
        shapes = [(int(tcp.shape[0]), sched.delta_rmax[gi],
                   int(tcp.shape[1]))
                  for gi in range(g) if want[gi] in ("vmem", "pallas")
                  for tcp in sched.tabs[gi][sn._TABLE_INDEX["tgt_cp"]]]
        calls.clear()
        _factorize_under(sn, sched, a, mode)
        assert calls == shapes and shapes
    assert kernels == ({"pallas"} if mode == "pallas"
                       else {"vmem", "pallas"})


# ---- a model of the span entry's split -------------------------------------
PART = 512      # elements of a row one warp takes (csrc/addback.cu)


def _span_kernel_model(lv, rows, starts, base_mis=0):
    """What ``addback_spans_vec`` of ``csrc/addback.cu`` does, element by
    element in Python: a row is cut into parts of ``PART``; a part's end of
    run is its LAST quad that holds a nonzero; the adds go on the
    destination's 16-byte grid (``base_mis``: misalignment of ``lv[0]`` in
    elements), a quad wholly inside the part as one 4-wide add when it has
    a nonzero, a quad cut by the part's ends or by the end of ``lv`` as
    scalar adds of its inside nonzeros. Returns the result and the counts of
    4-wide and scalar adds."""
    out = lv.astype(np.float64)
    n, (nslots, length) = lv.shape[0], rows.shape
    assert length % 4 == 0
    vec = scalar = 0
    for c in range(nslots):
        if starts[c] < 0:
            continue
        for off in range(0, length, PART):
            first = int(starts[c]) + off
            cnt = min(PART, length - off, n - first)      # the drop rule
            if cnt <= 0:
                continue
            src = rows[c, off: off + min(PART, length - off)]
            nq = (cnt + 3) // 4
            quads = [src[4 * i: 4 * i + 4] for i in range(nq)]
            nz = [i for i, q in enumerate(quads) if q.any()]
            if not nz:
                continue
            cnt = min(cnt, 4 * (nz[-1] + 1))              # the end of the run
            m = (base_mis + first) % 4
            for j in range((m + cnt + 3) // 4):
                e0 = 4 * j - m
                inside = [e for e in range(e0, e0 + 4) if 0 <= e < cnt]
                vals = [src[e] for e in inside]
                if not any(v != 0 for v in vals):
                    continue
                if len(inside) == 4:
                    assert (base_mis + first + e0) % 4 == 0   # aligned quad
                    vec += 1
                    for e, v in zip(inside, vals):
                        out[first + e] += v
                else:
                    for e, v in zip(inside, vals):
                        if v != 0:
                            scalar += 1
                            out[first + e] += v
    return out, vec, scalar


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("length", [512, 640, 36])
@pytest.mark.parametrize("start_mod", [0, 1, 2, 3])
def test_span_kernel_split_model_equals_the_plain_version(start_mod, length,
                                                          holes, cut):
    """The head/body/tail split and the end-of-run rule of the CUDA span
    kernel, modelled in Python, against ``addback_spans_reference``: every
    destination alignment, rows of one part, of a whole and a ragged part
    and shorter than a warp's step, zero runs INSIDE the live part (legal:
    the rule takes the last nonzero quad, not the first zero one) and spans
    cut by the end of ``lvals``."""
    rng = np.random.default_rng(100 * start_mod + length + 2 * holes + cut)
    nslots, n = 12, 3000
    rows = np.zeros((nslots, length), np.float32)
    for c in range(nslots):
        ln = int(rng.integers(1, length + 1))
        rows[c, :ln] = rng.standard_normal(ln)
        if holes:
            z0 = int(rng.integers(0, ln))
            rows[c, z0: z0 + 140] = 0.0           # longer than 32 quads
            rows[c, ln - 1] = 2.5
    rows[2] = 0.0
    starts = (4 * rng.integers(0, (n - length) // 4, nslots)
              + start_mod).astype(np.int32)
    if cut:
        starts[:5] = n - 1 - np.arange(5) * 29
    starts[4] = -1
    lv = rng.standard_normal(n).astype(np.float32)
    want = k4.addback_spans_reference(
        torch.as_tensor(lv.copy()), torch.as_tensor(rows),
        torch.as_tensor(starts)).numpy()
    for base_mis in (0, 3):
        got, vec, scalar = _span_kernel_model(lv, rows, starts, base_mis)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert vec > 0 or length < 8
        # at most the two end quads of a part go as scalars: 3 + 3 elements
        live_parts = sum(-(-length // PART) for c in range(nslots)
                         if starts[c] >= 0)
        assert scalar <= 6 * live_parts
