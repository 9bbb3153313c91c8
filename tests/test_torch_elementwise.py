"""``ops/elementwise.py`` of the port against the JAX package on the CPU:
``add``/``sub``/``mul_scalar``/``sum_elements``/``l2_norm``.

The same seeded numpy inputs go through both. The output pattern (``indptr``
and ``indices``, with the capacity padding and the explicit zeros the JAX
merges keep) must match exactly; float32 values to ``rtol=1e-5`` (sums taken
in another order), integers exactly (uint32 wraps as in JAX).
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu.ops.elementwise as je
import basic_sparse_matrix_tpu.utils.config as jcfg
import basic_sparse_matrix_tpu_torch as P
import basic_sparse_matrix_tpu_torch.ops.elementwise as pe
import basic_sparse_matrix_tpu_torch.utils.config as pcfg
from basic_sparse_matrix_tpu_torch.utils.errors import IncorrectDimensions

torch.set_num_threads(1)


def _coo(seed, rows, cols, nnz, dtype):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, nnz)
    c = rng.integers(0, cols, nnz)
    if np.dtype(dtype).kind == "f":
        v = rng.standard_normal(nnz).astype(dtype)
    else:
        lo = -100 if np.dtype(dtype).kind == "i" else 0
        v = rng.integers(lo, 255, nnz).astype(dtype)
    return r, c, v


def _both(shape, r, c, v, **kw):
    return (P.CSR.from_coo_arrays(shape, r, c, v, **kw),
            J.CSR.from_coo_arrays(shape, r, c, v, **kw))


def _same(p, j, exact):
    assert p.shape == j.shape
    assert np.array_equal(p.indptr.numpy(), np.asarray(j.indptr))
    assert np.array_equal(p.indices.numpy(), np.asarray(j.indices))
    pv, jv = p.values.numpy(), np.asarray(j.values)
    assert pv.dtype == jv.dtype and pv.shape == jv.shape
    if exact:
        assert np.array_equal(pv, jv)
    else:
        np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-7)
        # the explicit zeros kept are the same slots
        assert np.array_equal(pv == 0, jv == 0)


@pytest.fixture(params=["chunked", "planned"])
def merge_numeric(request):
    """Both values of the JAX ``merge_numeric`` option, set in both
    packages (the port runs one formulation for either)."""
    jprev, pprev = jcfg.get_config(), pcfg.get_config()
    jcfg.set_config(dataclasses.replace(jprev, merge_numeric=request.param))
    pcfg.set_config(dataclasses.replace(pprev, merge_numeric=request.param))
    yield request.param
    jcfg.set_config(jprev)
    pcfg.set_config(pprev)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32])
@pytest.mark.parametrize("shape,nnz", [((60, 60), 300), ((7, 500), 900),
                                       ((300, 3), 200)])
def test_add_sub_planned_match_jax(merge_numeric, dtype, shape, nnz):
    pa, ja = _both(shape, *_coo(1, *shape, nnz, dtype))
    pb, jb = _both(shape, *_coo(2, *shape, nnz, dtype))
    exact = np.dtype(dtype).kind != "f"
    _same(pe.add(pa, pb), je.add(ja, jb), exact)
    _same(pe.sub(pa, pb), je.sub(ja, jb), exact)   # uint32 wraps in both
    _same(pe.add_sparse(pb, pa), je.add_sparse(jb, ja), exact)
    out = pe.add(pa, pb)
    assert out.stored == pa.stored + pb.stored      # static capacity
    ref = np.asarray(ja.todense()) + np.asarray(jb.todense())
    assert np.allclose(out.todense().numpy(), ref, rtol=1e-5, atol=1e-6)
    assert pe.sub_sparse is pe.sub and pe.add_sparse is pe.add


def test_add_cancellation_keeps_explicit_zeros_like_jax():
    d = np.asarray([[1.0, 0, 2.0], [0, 3.0, 0]], dtype=np.float32)
    pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    pb, jb = P.CSR.from_dense(d), J.CSR.from_dense(d)
    out, ref = pe.sub(pa, pb), je.sub(ja, jb)
    _same(out, ref, exact=True)
    assert out.stored == 6 and out.count_nonzero() == 0
    _same(out.compacted(), ref.compacted(), exact=True)
    assert out.compacted().stored == 0


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32])
def test_duplicate_coordinates_take_the_keyspace_fallback(dtype):
    """An operand that stores a coordinate twice (here: built without
    merging, and the capacity-padded output of an earlier merge) makes the
    plan refuse; both packages then take the key-space merge."""
    shape = (40, 30)
    r, c, v = _coo(3, *shape, 400, dtype)
    pa, ja = _both(shape, r, c, v, sum_duplicates=False)
    pb, jb = _both(shape, *_coo(4, *shape, 200, dtype))
    with pytest.raises(pe._HasDuplicateCoords):
        pe._MergePlan(pa, pb)
    assert pe._use_keyspace(pa, pb) and je._use_keyspace(ja, jb)
    exact = np.dtype(dtype).kind != "f"
    _same(pe.add(pa, pb), je.add(ja, jb), exact)
    _same(pe.sub(pb, pa), je.sub(jb, ja), exact)
    # chained: (a + b) is capacity padded with repeats at (rows-1, cols-1)
    _same(pe.add(pe.add(pb, pb), pb), je.add(je.add(jb, jb), jb), exact)
    assert pa._merge_plans == []


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_duplicate_coordinates_take_the_sort_merge_when_cells_overflow(
        dtype, monkeypatch):
    """With the key space over its budget (lowered in both packages) the
    duplicate-safe merge is the stable sort + segment sum."""
    shape = (50, 45)
    r, c, v = _coo(5, *shape, 500, dtype)
    pa, ja = _both(shape, r, c, v, sum_duplicates=False)
    pb, jb = _both(shape, *_coo(6, *shape, 100, dtype), sum_duplicates=False)
    monkeypatch.setattr(pe, "KEYSPACE_BUDGET_BYTES", 64)
    monkeypatch.setattr(je, "KEYSPACE_BUDGET_BYTES", 64)
    assert not pe._use_keyspace(pa, pb) and not je._use_keyspace(ja, jb)
    exact = np.dtype(dtype).kind != "f"
    _same(pe.add(pa, pb), je.add(ja, jb), exact)
    _same(pe.sub(pa, pb), je.sub(ja, jb), exact)


def test_large_shape_duplicates_sort_merge_without_overflow():
    """rows·cols exceeds int32 and the key-space budget: the sort merge on
    64-bit keys."""
    n = 200_000
    r, c = [0, 0, n - 1, 5], [n - 1, n - 1, 0, 7]
    pa, ja = _both((n, n), r, c, np.asarray([1.0, 2.0, 3.0, 4.0], np.float32),
                   sum_duplicates=False)
    pb, jb = _both((n, n), [0, n - 1], [n - 1, 0],
                   np.asarray([10.0, 20.0], np.float32))
    _same(pe.add(pa, pb), je.add(ja, jb), exact=True)
    _same(pe.sub(pa, pb), je.sub(ja, jb), exact=True)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_empty_operands(dtype):
    shape = (5, 7)
    z = np.zeros(shape, dtype=dtype)
    pz, jz = P.CSR.from_dense(z), J.CSR.from_dense(z)
    pa, ja = _both(shape, *_coo(7, *shape, 12, dtype))
    for pout, jout in ((pe.add(pz, pz), je.add(jz, jz)),
                       (pe.sub(pz, pz), je.sub(jz, jz)),
                       (pe.add(pz, pa), je.add(jz, ja)),
                       (pe.sub(pa, pz), je.sub(ja, jz))):
        _same(pout, jout, exact=True)
    assert pe.add(pz, pz).stored == 0
    assert float(pe.sum_elements(pz)) == 0.0 == float(je.sum_elements(jz))
    assert float(pe.l2_norm(pz)) == 0.0 == float(je.l2_norm(jz))


def test_dimension_mismatch_raises():
    a = P.CSR.from_dense(np.ones((2, 3), np.float32))
    b = P.CSR.from_dense(np.ones((3, 2), np.float32))
    with pytest.raises(IncorrectDimensions):
        pe.add(a, b)
    with pytest.raises(IncorrectDimensions):
        pe.sub(a, b)


@pytest.mark.parametrize("dtype,scalar", [
    (np.float32, 3), (np.float32, -0.5), (np.int32, 3), (np.int32, -7),
    (np.uint32, 3), (np.uint32, np.uint32(4_000_000_000)), (np.int32, 2.9),
])
def test_mul_scalar_and_reductions_match_jax(dtype, scalar):
    shape = (60, 60)
    p, j = _both(shape, *_coo(8, *shape, 300, dtype))
    exact = np.dtype(dtype).kind != "f"
    _same(pe.mul_scalar(p, scalar), je.mul_scalar(j, scalar), exact)
    ps, js = pe.sum_elements(p).numpy(), np.asarray(je.sum_elements(j))
    assert ps.dtype == js.dtype
    if exact:
        assert ps == js
    else:
        np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-5)
    pn, jn = pe.l2_norm(p).numpy(), np.asarray(je.l2_norm(j))
    assert pn.dtype == jn.dtype == np.float32
    np.testing.assert_allclose(pn, jn, rtol=1e-5)


def test_u32_sum_wraps_like_jax():
    v = np.full(3, 2_000_000_000, dtype=np.uint32)
    p, j = _both((3, 3), [0, 1, 2], [0, 1, 2], v)
    assert int(pe.sum_elements(p)) == int(je.sum_elements(j)) \
        == (3 * 2_000_000_000) % 2**32


def test_plan_cache_second_call_builds_no_plan(monkeypatch):
    shape = (30, 30)
    a, _ = _both(shape, *_coo(9, *shape, 100, np.float32))
    b, _ = _both(shape, *_coo(10, *shape, 100, np.float32))
    built = []
    init = pe._MergePlan.__init__

    def counting(self, x, y):
        built.append((x, y))
        init(self, x, y)

    monkeypatch.setattr(pe._MergePlan, "__init__", counting)
    first = pe.add(a, b)
    assert len(built) == 1 and len(a._merge_plans) == 1
    second = pe.add(a, b)
    third = pe.sub(a, b)         # the same plan serves add and sub
    assert len(built) == 1
    assert second.indices is first.indices and third.indptr is first.indptr
    assert torch.equal(first.values, second.values)
    # new values on the same operands reuse the plan
    a.values.mul_(2.0)
    assert torch.allclose(pe.add(a, b).todense(),
                          a.todense() + b.todense())
    assert len(built) == 1
    # the reverse pair is another plan, memoised on the other operand
    pe.add(b, a)
    assert len(built) == 2 and len(b._merge_plans) == 1


def test_plan_cache_is_bounded_to_four_and_weakly_keyed(monkeypatch):
    shape = (20, 20)
    a, _ = _both(shape, *_coo(11, *shape, 50, np.float32))
    partners = [_both(shape, *_coo(20 + k, *shape, 50, np.float32))[0]
                for k in range(5)]
    built = []
    init = pe._MergePlan.__init__

    def counting(self, x, y):
        built.append(y)
        init(self, x, y)

    monkeypatch.setattr(pe._MergePlan, "__init__", counting)
    for b in partners:
        pe.add(a, b)
    assert len(built) == 5 and len(a._merge_plans) == 4
    pe.add(a, partners[4])           # still cached
    assert len(built) == 5
    pe.add(a, partners[0])           # the fifth partner evicted the first
    assert len(built) == 6 and built[-1] is partners[0]
    # a dead partner's entry never matches a new object
    del built[:]
    dead = partners.pop()
    del b
    del dead
    gc.collect()
    assert any(ref() is None for ref, _ in a._merge_plans)
