"""``ops/spgemm.py`` of the port against the JAX package on the CPU:
``spgemm``/``mul_sparse``, ``spgemm_dense``, ``spgemm_bounded``,
``spgemm_planned`` (every ``spgemm_numeric`` value, the row-chunked plan,
a skewed right operand) and ``SparseOperator.matmul_sparse``.

The same seeded numpy inputs go through both. Output patterns (``indptr``,
``indices``, explicit zeros and capacity padding included) must match
exactly; float32 values to ``rtol=1e-5`` with ``atol`` 1e-6 of the largest
magnitude (sums taken in another order); integers exactly.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu.utils.config as jcfg
import basic_sparse_matrix_tpu_torch as P
import basic_sparse_matrix_tpu_torch.utils.config as pcfg
from basic_sparse_matrix_tpu_torch.utils.errors import IncorrectDimensions

torch.set_num_threads(1)

# ``ops.spgemm`` names the function in both packages' ``ops`` namespaces, so
# ``import ... as`` would bind that; take the modules by name.
jg = importlib.import_module("basic_sparse_matrix_tpu.ops.spgemm")
pg = importlib.import_module("basic_sparse_matrix_tpu_torch.ops.spgemm")


def _dense(seed, rows, cols, density, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mask = rng.random((rows, cols)) < density
    if np.dtype(dtype).kind == "f":
        return (mask * rng.standard_normal((rows, cols))).astype(dtype)
    return (mask * rng.integers(1, 8, (rows, cols))).astype(dtype)


def _both(d):
    return P.CSR.from_dense(d), J.CSR.from_dense(d)


def _same(p, j, exact=False):
    assert p.shape == j.shape
    assert np.array_equal(p.indptr.numpy(), np.asarray(j.indptr))
    assert np.array_equal(p.indices.numpy(), np.asarray(j.indices))
    pv, jv = p.values.numpy(), np.asarray(j.values)
    assert pv.dtype == jv.dtype and pv.shape == jv.shape
    if exact:
        assert np.array_equal(pv, jv)
    else:
        scale = float(np.abs(jv).max()) if jv.size else 1.0
        np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-6 * scale)


SHAPES = [(30, 40, 25, 0.1), (64, 64, 64, 0.05), (5, 200, 7, 0.3),
          (120, 9, 80, 0.2)]


@pytest.mark.parametrize("m,k,n,density", SHAPES)
def test_spgemm_and_dense_match_jax(m, k, n, density):
    da, db = _dense(1, m, k, density), _dense(2, k, n, density)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    pd, jd = pg.spgemm_dense(pa, pb), np.asarray(jg.spgemm_dense(ja, jb))
    assert pd.dtype == torch.float32 and tuple(pd.shape) == jd.shape
    scale = float(np.abs(jd).max())
    np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-5, atol=1e-6 * scale)
    assert np.array_equal(pd.numpy() == 0, jd == 0)
    _same(pg.spgemm(pa, pb), jg.spgemm(ja, jb))
    _same(pg.mul_sparse(pa, pb), jg.mul_sparse(ja, jb))
    assert pg.mul_sparse is pg.spgemm
    ref = da.astype(np.float64) @ db.astype(np.float64)
    assert np.allclose(pg.spgemm(pa, pb).todense().numpy(), ref, rtol=1e-5,
                       atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_spgemm_integer_exact(dtype):
    da, db = _dense(3, 40, 40, 0.1, dtype), _dense(4, 40, 40, 0.1, dtype)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    _same(pg.spgemm(pa, pb), jg.spgemm(ja, jb), exact=True)
    _same(pg.spgemm_planned(pa, pb), jg.spgemm_planned(ja, jb), exact=True)
    _same(pg.spgemm_bounded(pa, pb, 10**5), jg.spgemm_bounded(ja, jb, 10**5),
          exact=True)
    ref = da.astype(np.uint64) @ db.astype(np.uint64)
    assert np.array_equal(
        pg.spgemm(pa, pb).todense().numpy().astype(np.uint64), ref)


def test_spgemm_past_the_dense_budget_takes_the_planned_path(monkeypatch):
    da, db = _dense(5, 50, 60, 0.1), _dense(6, 60, 45, 0.1)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    monkeypatch.setattr(pg, "DENSE_OUTPUT_BUDGET", 1000)
    monkeypatch.setattr(jg, "DENSE_OUTPUT_BUDGET", 1000)
    out = pg.spgemm(pa, pb)
    _same(out, jg.spgemm(ja, jb))
    assert pa._spgemm_plans and len(pa._spgemm_plans) == 1
    # the plan keeps cancellations and products of stored entries as they
    # are: no zero dropping on this path
    assert out.stored == pa._spgemm_plans[0][1].nnz_c


@pytest.mark.parametrize("m,k,n,density", SHAPES)
def test_spgemm_bounded_matches_jax(m, k, n, density):
    da, db = _dense(7, m, k, density), _dense(8, k, n, density)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    worst = pa.stored * int(np.diff(pb.numpy()[0]).max())
    out = pg.spgemm_bounded(pa, pb, worst)
    _same(out, jg.spgemm_bounded(ja, jb, worst))
    assert out.stored == worst                     # capacity padded
    _same(out.compacted(), jg.spgemm_bounded(ja, jb, worst).compacted())
    with pytest.raises(IncorrectDimensions):
        pg.spgemm_bounded(pa, pb, worst - 1)
    with pytest.raises(J.IncorrectDimensions):
        jg.spgemm_bounded(ja, jb, worst - 1)


@pytest.fixture(params=["planned", "chunked", "rowgather", "mergetree",
                        "auto"])
def spgemm_numeric(request):
    """Every value of the JAX ``spgemm_numeric`` option, set in both
    packages (the port runs one formulation for all of them)."""
    jprev, pprev = jcfg.get_config(), pcfg.get_config()
    jcfg.set_config(dataclasses.replace(jprev, spgemm_numeric=request.param))
    pcfg.set_config(dataclasses.replace(pprev, spgemm_numeric=request.param))
    yield request.param
    jcfg.set_config(jprev)
    pcfg.set_config(pprev)


@pytest.mark.parametrize("case", ["random", "long_rows"])
def test_spgemm_planned_matches_jax(spgemm_numeric, case):
    if case == "random":
        da, db = _dense(9, 70, 90, 0.08), _dense(10, 90, 60, 0.08)
    else:
        # matched B rows of 64: an expansion past 2^14, where the JAX
        # package's coalesced and row-gather variants engage
        rng = np.random.default_rng(11)
        da = _dense(12, 80, 300, 0.02)
        db = np.zeros((300, 400), np.float32)
        for r in range(300):
            db[r, rng.choice(400, 64, replace=False)] = \
                rng.standard_normal(64)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    out = pg.spgemm_planned(pa, pb)
    _same(out, jg.spgemm_planned(ja, jb))
    ref = da.astype(np.float64) @ db.astype(np.float64)
    assert np.allclose(out.todense().numpy(), ref, rtol=1e-5,
                       atol=1e-5 * np.abs(ref).max())
    if case == "long_rows":
        assert pa._spgemm_plans[0][1].expansion >= 1 << 14


def test_spgemm_planned_chunked_plan_equals_single_plan(monkeypatch):
    """With ``EXPANSION_BUDGET`` lowered (in the port only) the product is
    planned and run in row chunks; pattern and values equal the single
    plan's and the JAX package's."""
    da, db = _dense(13, 90, 50, 0.15), _dense(14, 50, 70, 0.15)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    single = pg.spgemm_planned(pa, pb)
    total = pa._spgemm_plans[0][1].expansion
    assert isinstance(pa._spgemm_plans[0][1], pg._SpgemmPlan)
    pa2 = P.CSR.from_dense(da)
    monkeypatch.setattr(pg, "EXPANSION_BUDGET", total // 7)
    chunked = pg.spgemm_planned(pa2, pb)
    plan = pa2._spgemm_plans[0][1]
    assert isinstance(plan, pg._SpgemmChunkedPlan)
    assert len(plan.chunks) >= 7 and plan.expansion == total
    assert all(p.expansion <= total // 7 or p.rows == 1
               for _, _, p in plan.chunks)
    _same(chunked, jg.spgemm_planned(ja, jb))
    assert np.array_equal(chunked.indptr.numpy(), single.indptr.numpy())
    assert np.array_equal(chunked.indices.numpy(), single.indices.numpy())
    np.testing.assert_allclose(chunked.values.numpy(), single.values.numpy(),
                               rtol=1e-6)


def test_single_row_over_budget_is_its_own_chunk(monkeypatch):
    da = np.zeros((4, 6), np.float32)
    da[1] = 1.0
    da[3, 0] = 2.0
    db = np.ones((6, 5), np.float32)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    monkeypatch.setattr(pg, "EXPANSION_BUDGET", 4)
    out = pg.spgemm_planned(pa, pb)
    _same(out, jg.spgemm_planned(ja, jb), exact=True)
    assert np.array_equal(out.todense().numpy(), da @ db)


def test_skewed_right_operand_with_one_dense_row():
    """One dense row in B: the worst-case bound ``nnz(A)·max_row(B)`` is
    far above the actual expansion, which the plan sizes exactly."""
    rng = np.random.default_rng(15)
    da = _dense(16, 60, 80, 0.05)
    db = _dense(17, 80, 500, 0.004)
    db[7] = rng.standard_normal(500)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    out = pg.spgemm_planned(pa, pb)
    _same(out, jg.spgemm_planned(ja, jb))
    plan = pa._spgemm_plans[0][1]
    assert plan.expansion == int(np.diff(pb.numpy()[0])[pa.numpy()[1]].sum())
    assert plan.expansion < pa.stored * 500 // 5
    ref = da.astype(np.float64) @ db.astype(np.float64)
    assert np.allclose(out.todense().numpy(), ref, rtol=1e-5,
                       atol=1e-5 * np.abs(ref).max())


def test_planned_cache_and_empty_operands(monkeypatch):
    da, db = _dense(18, 20, 30, 0.2), _dense(19, 30, 10, 0.2)
    pa, pb = P.CSR.from_dense(da), P.CSR.from_dense(db)
    built = []
    build = pg._build_plan
    monkeypatch.setattr(pg, "_build_plan",
                        lambda a, b: built.append(1) or build(a, b))
    first = pg.spgemm_planned(pa, pb)
    second = pg.spgemm_planned(pa, pb)
    assert len(built) == 1 and second.indices is first.indices
    others = [P.CSR.from_dense(_dense(30 + k, 30, 10, 0.2)) for k in range(4)]
    for o in others:
        pg.spgemm_planned(pa, o)
    assert len(built) == 5 and len(pa._spgemm_plans) == 4
    pg.spgemm_planned(pa, pb)                       # evicted by the fifth
    assert len(built) == 6
    z = P.CSR.from_dense(np.zeros((30, 10), np.float32))
    jz = J.CSR.from_dense(np.zeros((30, 10), np.float32))
    ja = J.CSR.from_dense(da)
    for fn, jfn in ((pg.spgemm_planned, jg.spgemm_planned),
                    (pg.spgemm, jg.spgemm)):
        out = fn(pa, z)
        _same(out, jfn(ja, jz), exact=True)
        assert out.shape == (20, 10) and out.stored == 0
    out = pg.spgemm_bounded(pa, z, 0)
    assert out.shape == (20, 10) and out.stored == 0


@pytest.mark.parametrize("fn", ["spgemm", "spgemm_planned", "spgemm_bounded"])
def test_inner_dimension_is_checked(fn):
    a = P.CSR.from_dense(np.ones((3, 4), np.float32))
    b = P.CSR.from_dense(np.ones((5, 2), np.float32))
    args = (a, b, 100) if fn == "spgemm_bounded" else (a, b)
    with pytest.raises(IncorrectDimensions):
        getattr(pg, fn)(*args)


def test_matmul_sparse_matches_jax(monkeypatch):
    from basic_sparse_matrix_tpu.models.operator import (
        SparseOperator as JOp)

    da, db = _dense(20, 45, 45, 0.1), _dense(21, 45, 33, 0.1)
    (pa, ja), (pb, jb) = _both(da), _both(db)
    _same(P.SparseOperator(pa).matmul_sparse(pb),
          JOp(ja).matmul_sparse(jb))
    monkeypatch.setattr(pg, "DENSE_OUTPUT_BUDGET", 1000)
    monkeypatch.setattr(jg, "DENSE_OUTPUT_BUDGET", 1000)
    _same(P.SparseOperator(pa).matmul_sparse(pb),
          JOp(ja).matmul_sparse(jb))
