"""Batched values in the PyTorch port: one pattern, one symbolic schedule,
many numeric systems, against ``jax.vmap`` of the JAX functions on the CPU.

* the three cases of ``tests/test_batched.py`` (scatter-list factorization,
  SpMM over a batch of right-hand sides, SpMM over a batch of values);
* ``spmm_auto``/``mul_dense`` with ``b`` (Bt, K, N) on each rung of the
  ladder and with an empty ``b`` (JAX's zeros), and ``spmm(values=…)``
  with a shared and a per-system RHS, in chunks;
* the triangular solves on ``schedule_values`` against ``jax.vmap`` of
  ``_solve_scheduled`` over schedules stacked from each system's factor,
  forward and mirrored, and factor → solve through ``csr_value_order``;
* the batched plain versions of K3 and of the add-back's rect and span
  entries against a Python loop of the one-system call, bit for bit;
* a non-SPD system in a batch leaves the others' factors finite and equal
  to their single-system factors (supernodal under every scatter mode,
  scatter-list);
* a batch of one equals the unbatched call bit for bit;
* ``ops.__all__`` against the JAX package's.

Tolerances: float32 against float32 summed in another order, ``rtol=1e-5``
and ``atol=1e-6·max|ref|`` for the factors and solves, ``rtol=1e-4``,
``atol=1e-4`` for SpMM (the JAX tests' bound). The batched supernodal
factorization against ``jax.vmap`` under each mode is in
``tests/test_torch_batched_supernodal.py``; the batched kernels and the
batched factorization on the card in ``tests/test_torch_cuda_kernels.py``
(``cuda`` marker: this file imports jax, which the card's machine lacks).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu.ops as jops
import basic_sparse_matrix_tpu_torch as P
import basic_sparse_matrix_tpu_torch.ops as pops
from basic_sparse_matrix_tpu.models import sparse_cholesky as jsc
from basic_sparse_matrix_tpu.models import sparse_triangular as jst
from basic_sparse_matrix_tpu.ops.spmm import spmm as jspmm
from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as psc
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.models import supernodal as psn
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3
from basic_sparse_matrix_tpu_torch.runtime import checkpoint as pckpt
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

# the module (ops/__init__.py binds the function ``spmm`` over it)
pspmm = importlib.import_module("basic_sparse_matrix_tpu_torch.ops.spmm")

torch.set_num_threads(1)

RTOL = 1e-5
ATOL_OF_MAX = 1e-6
SCATTERS = ("element", "delta", "pallas", "vmem")


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


@pytest.fixture
def solver_config():
    """Set supernodal_gather / supernodal_scatter for one test."""
    old = pcfg.get_config()

    def set_(**fields):
        pcfg.set_config(dataclasses.replace(old, **fields))
    yield set_
    pcfg.set_config(old)


def _close(got, want, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max(initial=0.0)), 1e-30))


def _lap2(k):
    """The 5-point Laplacian on a k×k grid as COO arrays."""
    n = k * k
    idx = np.arange(n).reshape(k, k)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 4.0)]
    for ax in range(2):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def _family(pa, bt, seed, fail=None):
    """``bt`` value sets of ``pa``'s pattern, ``s_b·A + c_b·I`` with seeded
    ``s_b`` in [1, 2) and ``c_b`` in [0, 1) (SPD); system ``fail`` gets
    ``c_b = -20``, which makes it indefinite. Returns a (bt, nnz) float32
    numpy array."""
    rng = np.random.default_rng(seed)
    indptr, indices, values = pa.numpy()
    rows = np.repeat(np.arange(pa.rows), np.diff(indptr))
    diag = (indices == rows).astype(np.float32)
    s = (1.0 + rng.random(bt)).astype(np.float32)
    c = rng.random(bt).astype(np.float32)
    if fail is not None:
        c[fail] = -20.0
    return (s[:, None] * values[None, :] + c[:, None] * diag[None, :]
            ).astype(np.float32)


def _nd_lap(k, device=None):
    n, r, c, v = _lap2(k)
    pa = P.CSR.from_coo_arrays((n, n), r, c, v, device=device)
    return pr.permute_symmetric(pa, pr.nd_permutation(pa))


# ---- tests/test_batched.py, against jax.vmap ------------------------------

def _tridiag(n):
    return (4 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(
        np.float32)


def test_vmapped_factorization():
    n, batch = 16, 5
    base = _tridiag(n)
    ja, pa = J.CSR.from_dense(base), P.CSR.from_dense(base)
    rng = np.random.default_rng(0)
    scales = (1.0 + rng.random(batch)).astype(np.float32)
    vals = scales[:, None] * pa.numpy()[2][None, :]
    jsched = jsc.analyze(ja)
    want = jax.vmap(lambda v: jsc.factorize(jsched, v))(jnp.asarray(vals))
    sched = psc.analyze(pa)
    got = psc.factorize(sched, torch.as_tensor(vals))
    assert got.shape == (batch, sched.nnz_l)
    _close(got, want)
    for i, s in enumerate(scales):
        ref = np.linalg.cholesky((s * base).astype(np.float64))
        dense = psc.csc_to_csr_l(sched, got[i]).todense().numpy()
        assert np.allclose(dense, ref, rtol=1e-4, atol=1e-5)


def _spmm_case(name):
    rng = np.random.default_rng(1)
    if name == "test_batched":        # tests/test_batched.py's operand
        d = ((rng.random((20, 30)) < 0.2)
             * rng.standard_normal((20, 30))).astype(np.float32)
    elif name == "ell":               # sparse, even rows: the ELL rung
        d = ((rng.random((200, 300)) < 0.02)
             * rng.standard_normal((200, 300))).astype(np.float32)
    else:                             # one dense row: the gather rung
        d = ((rng.random((200, 300)) < 0.01)
             * rng.standard_normal((200, 300))).astype(np.float32)
        d[7] = rng.standard_normal(300)
    return d


@pytest.mark.parametrize("case", ["test_batched", "ell", "gather"])
@pytest.mark.parametrize("entry", ["mul_dense", "spmm_auto"])
def test_vmapped_spmm(case, entry):
    d = _spmm_case(case)
    rng = np.random.default_rng(2)
    bb = rng.standard_normal((4, d.shape[1], 8)).astype(np.float32)
    ja, pa = J.CSR.from_dense(d), P.CSR.from_dense(d)
    want = jax.vmap(lambda x: jspmm(ja, x))(jnp.asarray(bb))
    got = getattr(pspmm, entry)(pa, torch.as_tensor(bb))
    assert got.shape == (4, d.shape[0], 8) and got.is_contiguous()
    _close(got, want, rtol=1e-4, atol_of_max=1e-4)
    for i in range(4):
        assert np.allclose(got[i].numpy(), d @ bb[i], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(0, 9, 5), (2, 9, 0), (9, 0)])
@pytest.mark.parametrize("entry", ["mul_dense", "spmm_auto"])
def test_empty_rhs_gives_jax_zeros(entry, shape):
    """An empty RHS, batched or not: zeros of JAX's shape, (0, 7, 5),
    (2, 7, 0) and (7, 0)."""
    rng = np.random.default_rng(0)
    d = ((rng.random((7, 9)) < 0.3)
         * rng.integers(1, 9, (7, 9))).astype(np.float32)
    ja, pa = J.CSR.from_dense(d), P.CSR.from_dense(d)
    b = np.zeros(shape, dtype=np.float32)
    if len(shape) == 3:
        want = jax.vmap(lambda x: jops.mul_dense(ja, x))(jnp.asarray(b))
    else:
        want = jops.mul_dense(ja, jnp.asarray(b))
    got = getattr(pspmm, entry)(pa, torch.as_tensor(b))
    assert got.shape == want.shape == (shape[:-2] + (7, shape[-1]))
    assert np.array_equal(got.numpy(), np.asarray(want))


def _values_case():
    rng = np.random.default_rng(2)
    d = ((rng.random((15, 15)) < 0.3)
         * rng.standard_normal((15, 15))).astype(np.float32)
    b = rng.standard_normal((15, 4)).astype(np.float32)
    vals = rng.standard_normal((3, int((d != 0).sum()))).astype(np.float32)
    return d, b, vals


@pytest.mark.parametrize("per_system_rhs", [False, True])
def test_vmapped_values_spmm(per_system_rhs):
    d, b, vals = _values_case()
    ja, pa = J.CSR.from_dense(d), P.CSR.from_dense(d)
    rhs = np.stack([b * (i + 1) for i in range(3)]) if per_system_rhs else b

    def run(v, x):
        return jspmm(J.CSR(ja.indptr, ja.indices, v, ja.rows, ja.cols), x)
    want = jax.vmap(run, in_axes=(0, 0 if per_system_rhs else None))(
        jnp.asarray(vals), jnp.asarray(rhs))
    got = pspmm.spmm(pa, torch.as_tensor(rhs), values=torch.as_tensor(vals))
    assert got.shape == (3, 15, 4)
    _close(got, want, rtol=1e-4, atol_of_max=1e-4)
    indptr, indices, _ = pa.numpy()
    rows = np.repeat(np.arange(15), np.diff(indptr))
    for i in range(3):
        dense = np.zeros((15, 15), dtype=np.float32)
        dense[rows, indices] = vals[i]
        x = rhs[i] if per_system_rhs else rhs
        assert np.allclose(got[i].numpy(), dense @ x, rtol=1e-4, atol=1e-4)


def test_values_spmm_chunks_sum_as_one_pass(monkeypatch):
    """Entry chunks bounded by ``VALUES_CHUNK_BYTES`` add in the same order
    as one pass: bit for bit."""
    d, b, vals = _values_case()
    pa = P.CSR.from_dense(d)
    one = pspmm.spmm(pa, torch.as_tensor(b), values=torch.as_tensor(vals))
    monkeypatch.setattr(pspmm, "VALUES_CHUNK_BYTES", 3 * 4 * 4 * 5)
    chunked = pspmm.spmm(pa, torch.as_tensor(b), values=torch.as_tensor(vals))
    assert torch.equal(one, chunked)


def test_batched_spmm_rejects_mismatched_shapes():
    d, b, vals = _values_case()
    pa = P.CSR.from_dense(d)
    with pytest.raises(P.IncorrectDimensions):
        pspmm.spmm(pa, torch.as_tensor(b), values=torch.as_tensor(vals[:, 1:]))
    with pytest.raises(P.IncorrectDimensions):
        pspmm.spmm(pa, torch.zeros((2, 15, 4)), values=torch.as_tensor(vals))
    with pytest.raises(P.IncorrectDimensions):
        pspmm.mul_dense(pa, torch.zeros((2, 14, 4)))
    with pytest.raises(P.IncorrectDimensions):
        pspmm.mul_dense(pa, torch.zeros((2, 3, 15, 4)))


# ---- triangular solves ------------------------------------------------------

def _stack(scheds):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *scheds)


@pytest.mark.parametrize("k,bt,rhs", [(5, 3, (3,)), (6, 4, ()), (4, 1, (2,))])
def test_vmapped_triangular_solves(k, bt, rhs):
    n, r, c, v = _lap2(k)
    ja = J.CSR.from_coo_arrays((n, n), r, c, v)
    pa = P.CSR.from_coo_arrays((n, n), r, c, v)
    vals = _family(pa, bt, seed=k)
    b = np.random.default_rng(k + 1).standard_normal(
        (bt, n) + rhs).astype(np.float32)

    jsched = jsc.analyze(ja)
    jl = jax.vmap(lambda x: jsc.factorize(jsched, x))(jnp.asarray(vals))
    ls = [jsc.csc_to_csr_l(jsched, np.asarray(jl[i])) for i in range(bt)]
    fwd = _stack([jst.build_schedule(l) for l in ls])
    bwd = _stack([jst.build_schedule(l.transpose(), lower=False)
                  for l in ls])
    jy = jax.vmap(jst._solve_scheduled)(fwd, jnp.asarray(b))
    jx = jnp.flip(jax.vmap(jst._solve_scheduled)(bwd, jnp.flip(jy, 1)), 1)

    sched = psc.analyze(pa)
    lv = psc.factorize(sched, torch.as_tensor(vals))
    l0 = psc.csc_to_csr_l(sched, lv[0])
    lt = l0.transpose()
    rows, cols = pst.factor_pattern(sched)
    pf, pb = pst.build_schedule(l0), pst.build_schedule(lt, lower=False)
    vf = pst.schedule_values(pf, lv[:, pst.csr_value_order(rows, cols, l0)])
    vb = pst.schedule_values(pb, lv[:, pst.csr_value_order(cols, rows, lt)])
    y = pst.solve_triangular_sparse(l0, torch.as_tensor(b), pf, values=vf)
    x = pst.solve_triangular_sparse(lt, y, pb, lower=False, values=vb)
    assert y.shape == x.shape == b.shape
    _close(y, jy)
    _close(x, jx)
    # each system against its own schedule, solved alone
    for i in range(bt):
        li = psc.csc_to_csr_l(sched, lv[i])
        yi = pst.solve_triangular_sparse(li, torch.as_tensor(b[i]))
        xi = pst.solve_triangular_sparse(li.transpose(), yi, lower=False)
        _close(x[i], xi)


def test_schedule_values_of_the_scheduled_matrix_are_its_own():
    """On the values the schedule was built from, ``schedule_values`` gives
    its ``vals`` and ``inv_diag`` bit for bit, forward and mirrored."""
    pa = _nd_lap(6)
    sched = psc.analyze(pa)
    lv = psc.factorize(sched, pa.values)
    l = psc.csc_to_csr_l(sched, lv)
    for m, lower in ((l, True), (l.transpose(), False)):
        s = pst.build_schedule(m, lower=lower)
        vals, inv = pst.schedule_values(s, m.values[None])
        assert torch.equal(vals[0], s.vals) and torch.equal(inv[0], s.inv_diag)


@pytest.mark.parametrize("relax", [0, 8])
def test_supernodal_factor_to_batched_solve(relax):
    """``factorize_supernodal`` on a batch, then the batched solves through
    ``csr_value_order`` on one assembled pattern: each system's solution
    solves its own matrix (float64 residual) and equals its single-system
    solve."""
    pa = _nd_lap(7)
    n, bt = pa.rows, 3
    vals = torch.as_tensor(_family(pa, bt, seed=relax))
    sched = psn.analyze_supernodal(pa, relax=relax)
    lv = psn.factorize_supernodal(sched, vals)
    l0 = psn.assemble_factor(pa, lv[0], sched)
    lt = l0.transpose()
    rows, cols = pst.factor_pattern(sched)
    pf, pb = pst.build_schedule(l0), pst.build_schedule(lt, lower=False)
    vf = pst.schedule_values(pf, lv[:, pst.csr_value_order(rows, cols, l0)])
    vb = pst.schedule_values(pb, lv[:, pst.csr_value_order(cols, rows, lt)])
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (bt, n, 2)).astype(np.float32))
    x = pst.solve_triangular_sparse(
        lt, pst.solve_triangular_sparse(l0, b, pf, values=vf), pb,
        lower=False, values=vb)
    indptr, indices, _ = pa.numpy()
    for i in range(bt):
        a_i = np.zeros((n, n))
        a_i[np.repeat(np.arange(n), np.diff(indptr)), indices] = vals[i]
        res = b[i].double().numpy() - a_i @ x[i].double().numpy()
        assert np.abs(res).max() <= 1e-4 * np.abs(b[i].numpy()).max()
        li = psn.assemble_factor(pa, lv[i], sched)
        xi = pst.solve_triangular_sparse(
            li.transpose(), pst.solve_triangular_sparse(li, b[i]),
            lower=False)
        _close(x[i], xi)


def test_csr_value_order_rejects_a_foreign_pattern():
    pa = _nd_lap(4)
    sched = psc.analyze(pa)
    rows, cols = pst.factor_pattern(sched)
    l = psc.csc_to_csr_l(sched, psc.factorize(sched, pa.values))
    with pytest.raises(P.IncorrectDimensions):
        pst.csr_value_order(rows[1:], cols[1:], l)


def test_batched_solve_rejects_mismatched_values():
    pa = _nd_lap(4)
    sched = psc.analyze(pa)
    l = psc.csc_to_csr_l(sched, psc.factorize(sched, pa.values))
    s = pst.build_schedule(l)
    vals = pst.schedule_values(s, l.values[None].repeat(2, 1))
    with pytest.raises(P.IncorrectDimensions):
        pst.solve_triangular_sparse(l, torch.zeros((3, l.rows)), s,
                                    values=vals)
    with pytest.raises(P.IncorrectDimensions):
        pst.solve_triangular_sparse(l, torch.zeros((2, l.rows + 1)), s,
                                    values=vals)


# ---- the kernels' plain versions with a batch axis --------------------------

@pytest.mark.parametrize("n,crq,l_pad,bt", [
    (300, 40, 37, 3), (1000, 128, 128, 5), (50, 9, 64, 2), (10, 4, 1, 1)])
def test_runs_read_reference_batched_is_the_loop(n, crq, l_pad, bt):
    rng = np.random.default_rng(n + crq)
    lv = torch.as_tensor(rng.standard_normal((bt, n)).astype(np.float32))
    stf = rng.integers(0, n, crq).astype(np.int32)
    stf[::3] = -1
    stf[1::4] = n - 1            # past the end of a system: zeros, not the next
    stf = torch.as_tensor(stf)
    got = k3.runs_read(lv, stf, l_pad)
    assert got.shape == (bt, crq, l_pad)
    want = torch.stack([k3.runs_read(lv[i], stf, l_pad) for i in range(bt)])
    assert torch.equal(got, want)
    starts = stf[: crq // 2 * 2].reshape(2, -1).long()
    out = k3.win_kernel(lv, starts, min(l_pad, 5), l_pad)
    assert torch.equal(out, torch.stack([k3.win_kernel(
        lv[i], starts, min(l_pad, 5), l_pad) for i in range(bt)]))


def _rects(rng, bt, st, rd, wt, n, idx):
    p = torch.as_tensor(rng.standard_normal((bt, st, rd, wt)).astype(
        np.float32))
    tcp = torch.as_tensor(rng.integers(0, n, (st, wt))).to(idx)
    tnr = torch.as_tensor(rng.integers(0, rd + 1, st)).to(idx)
    twd = torch.as_tensor(rng.integers(0, wt + 1, st)).to(idx)
    tnr[0], twd[0] = rd, wt
    lv = torch.as_tensor(rng.standard_normal((bt, n)).astype(np.float32))
    return lv, p, tcp, tnr, twd


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("bt,st,rd,wt,n", [
    (3, 4, 40, 8, 300), (2, 9, 130, 5, 2000), (5, 2, 12, 3, 40)])
def test_addback_rects_reference_batched_is_the_loop(bt, st, rd, wt, n, idx):
    """Runs cut by the end of ``lvals`` drop their tail in each system."""
    lv, p, tcp, tnr, twd = _rects(np.random.default_rng(bt * st + rd), bt,
                                  st, rd, wt, n, idx)
    got = k4.addback_rects(lv.clone(), p, tcp, tnr, twd)
    want = torch.stack([k4.addback_rects(lv[i].clone(), p[i], tcp, tnr, twd)
                        for i in range(bt)])
    assert torch.equal(got, want)


def test_span_entry_plain_versions_batched_are_the_loop():
    """The span entry's plain versions take a batch, as the JAX package's
    kernels do under ``jax.vmap``: both layouts, bit for bit against the
    loop."""
    rng = np.random.default_rng(5)
    bt, n = 3, 500
    lv = torch.as_tensor(rng.standard_normal((bt, n)).astype(np.float32))
    rows = torch.as_tensor(rng.standard_normal((bt, 12, 64)).astype(
        np.float32))
    starts = torch.as_tensor(rng.integers(-1, n, 12).astype(np.int32))
    got = k4.addback_resident(lv.clone(), rows, starts)
    want = torch.stack([k4.addback_resident(lv[i].clone(), rows[i], starts)
                        for i in range(bt)])
    assert torch.equal(got, want)
    psh = rows.reshape(bt, 3, 4, 64)
    tcp = starts.reshape(3, 4).clamp(min=0)
    twd = torch.tensor([4, 0, 2], dtype=torch.int32)
    got = k5.panel_addback(lv.clone(), psh, tcp, twd)
    want = torch.stack([k5.panel_addback(lv[i].clone(), psh[i], tcp, twd)
                        for i in range(bt)])
    assert torch.equal(got, want)


def test_batched_wrappers_reject_mismatched_shapes():
    lv = torch.zeros((2, 100))
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError):
        k3.runs_read(torch.zeros((2, 3, 100)), torch.zeros(4, **i32), 8)
    with pytest.raises(ValueError):         # p's batch differs from lvals'
        k4.addback_rects(lv, torch.zeros((3, 2, 8, 3)),
                         torch.zeros((2, 3), **i32), torch.zeros(2, **i32),
                         torch.zeros(2, **i32))
    with pytest.raises(ValueError):         # a batched lvals with 1-D rects
        k4.addback_rects(lv, torch.zeros((2, 8, 3)),
                         torch.zeros((2, 3), **i32), torch.zeros(2, **i32),
                         torch.zeros(2, **i32))
    with pytest.raises(ValueError):
        k4.addback_resident(lv, torch.zeros((3, 4, 8)), torch.zeros(4, **i32))


# ---- failed systems and the batch of one ------------------------------------

@pytest.mark.parametrize("scatter", SCATTERS)
def test_a_failed_system_leaves_the_others_alone(scatter, solver_config):
    """System 1 is indefinite: its factor holds NaN; the others are finite
    and equal their single-system factors (bit for bit under "element";
    the merged-rect routes sum the batch's one-hot merges in one product,
    whose float32 rounding may differ in the last bit)."""
    solver_config(supernodal_gather="window", supernodal_scatter=scatter)
    pa = _nd_lap(7)
    vals = torch.as_tensor(_family(pa, 3, seed=11, fail=1))
    sched = psn.analyze_supernodal(pa, relax=4)
    got = psn.factorize_supernodal(sched, vals)
    assert bool(torch.isnan(got[1]).any())
    for i in (0, 2):
        one = psn.factorize_supernodal(sched, vals[i])
        assert bool(torch.isfinite(got[i]).all())
        if scatter == "element":
            assert torch.equal(got[i], one)
        else:
            _close(got[i], one, rtol=1e-6, atol_of_max=1e-7)


def test_a_failed_system_leaves_the_others_alone_scatter_list():
    pa = _nd_lap(6)
    vals = torch.as_tensor(_family(pa, 3, seed=12, fail=0))
    sched = psc.analyze(pa)
    got = psc.factorize(sched, vals)
    assert bool(torch.isnan(got[0]).any())
    for i in (1, 2):
        assert torch.equal(got[i], psc.factorize(sched, vals[i]))


@pytest.mark.parametrize("gather,scatter", [
    ("element", "element"), ("window", "delta"), ("kernel", "pallas"),
    ("auto", "vmem"), ("auto", "auto")])
def test_a_batch_of_one_is_the_unbatched_call(gather, scatter, solver_config):
    solver_config(supernodal_gather=gather, supernodal_scatter=scatter)
    pa = _nd_lap(8)
    sched = psn.analyze_supernodal(pa, relax=8)
    one = psn.factorize_supernodal(sched, pa.values)
    batch = psn.factorize_supernodal(sched, pa.values[None])
    assert batch.shape == (1, sched.nnz_l)
    assert torch.equal(batch[0], one)


def test_a_batch_of_one_is_the_unbatched_call_elsewhere():
    """Scatter-list factor, triangular solves, both SpMM entries."""
    pa = _nd_lap(6)
    sched = psc.analyze(pa)
    lv = psc.factorize(sched, pa.values)
    assert torch.equal(psc.factorize(sched, pa.values[None])[0], lv)
    l = psc.csc_to_csr_l(sched, lv)
    s = pst.build_schedule(l)
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (pa.rows, 3)).astype(np.float32))
    vals = pst.schedule_values(s, l.values[None])
    assert torch.equal(pst.solve_triangular_sparse(l, b[None], s,
                                                   values=vals)[0],
                       pst.solve_triangular_sparse(l, b, s))
    assert torch.equal(pspmm.mul_dense(pa, b[None])[0],
                       pspmm.mul_dense(pa, b))
    assert torch.equal(pspmm.spmm(pa, b, values=pa.values[None])[0],
                       pspmm.spmm(pa, b))


def test_factorizations_reject_other_ranks():
    pa = _nd_lap(4)
    with pytest.raises(ValueError):
        psn.factorize_supernodal(psn.analyze_supernodal(pa),
                                 pa.values.reshape(1, 1, -1))
    with pytest.raises(ValueError):
        psc.factorize(psc.analyze(pa), pa.values.reshape(1, 1, -1))


def test_checkpointed_factorize_takes_one_system(tmp_path):
    pa = _nd_lap(4)
    sched = psc.analyze(pa)
    with pytest.raises(ValueError, match="one system"):
        pckpt.checkpointed_factorize(sched, pa.values[None].repeat(2, 1),
                                     str(tmp_path / "state.npz"))


# ---- the ops namespace -------------------------------------------------------

# Names of the JAX package's ops namespace the port spells otherwise: the
# port's sparse interop is torch.sparse, not jax.experimental.sparse.
OPS_RENAMED = {"to_bcoo": "to_torch_sparse", "from_bcoo": "from_torch_sparse"}


def test_ops_exports_match_the_jax_package():
    want = {OPS_RENAMED.get(name, name) for name in jops.__all__}
    assert set(pops.__all__) == want
    for name in pops.__all__:
        assert getattr(pops, name) is not None
    from basic_sparse_matrix_tpu_torch.ops import reorder
    for name in ("apply_perm", "bandwidth", "permute_symmetric",
                 "rcm_permutation"):
        assert getattr(pops, name) is getattr(reorder, name)

