"""The four dispatcher regression cases of ``tests/test_dispatch_regressions
.py`` on the port, on the same inputs, against the JAX package's results:

1. ``cholesky_auto`` through its supernodal branch with a relaxed
   (expanded) pattern must assemble the factor WITH the schedule: the factor
   equals the dense one and the JAX package's (rtol 1e-4, atol 1e-4, the
   JAX test's own tolerance: two float32 factorizations);
2. ``assemble_factor`` without the schedule must refuse values of the
   expanded length, not truncate them;
3. ``bsr_profitable`` must agree with itself before and after the BSR cache
   exists (``force=True`` opens the device gate on the CPU) and with the JAX
   package;
4. the BSR rung driven twice on one matrix (the second call from the cached
   layout) must equal the gather oracle both times and the result of the
   JAX package's ``spmm_auto`` forced onto its BSR branch. The port's
   ``spmm_auto`` opens that rung only for a tensor on the card, so here the
   rung is called by name (``spmm_bsr_from_csr``, the plain version on the
   CPU) and ``spmm_auto`` itself is driven twice beside it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu import CSR as JCSR
from basic_sparse_matrix_tpu.ops.pallas import spmm_kernel as jk
from basic_sparse_matrix_tpu.utils import config as jcfg
from basic_sparse_matrix_tpu_torch import CSR
from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as pk
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


@pytest.fixture
def small_dense_threshold():
    """Shrink both packages' dense-Cholesky cutoffs so auto dispatch reaches
    the sparse branches at test-sized matrices; restore them afterwards."""
    old_j, old_p = jcfg.get_config(), pcfg.get_config()
    jcfg.set_config(dataclasses.replace(
        old_j, dense_cholesky_max_n=16, dense_cholesky_min_density=1.1))
    pcfg.set_config(dataclasses.replace(
        old_p, dense_cholesky_max_n=16, dense_cholesky_min_density=1.1))
    yield
    jcfg.set_config(old_j)
    pcfg.set_config(old_p)


def _lap2d(k):
    n = k * k
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(k):
        for j in range(k):
            r = i * k + j
            a[r, r] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < k and 0 <= jj < k:
                    a[r, ii * k + jj] = -1.0
    return a


@pytest.mark.parametrize("k", [8, 12])
def test_cholesky_auto_supernodal_branch_correct(small_dense_threshold, k):
    from basic_sparse_matrix_tpu.models.cholesky import (
        cholesky_auto as j_auto)
    from basic_sparse_matrix_tpu.ops import reorder as jr
    from basic_sparse_matrix_tpu_torch.models.cholesky import cholesky_auto
    from basic_sparse_matrix_tpu_torch.models.supernodal import (
        analyze_supernodal)
    from basic_sparse_matrix_tpu_torch.ops import reorder

    ja = JCSR.from_dense(_lap2d(k))
    ja = jr.permute_symmetric(ja, jr.rcm_permutation(ja))
    a = CSR.from_dense(_lap2d(k))
    a = reorder.permute_symmetric(a, reorder.rcm_permutation(a))
    dense = a.todense().numpy()
    assert np.array_equal(dense, np.asarray(ja.todense()))  # same inputs
    # the branch runs, and the relaxed pattern is expanded against relax=0
    cfg = pcfg.get_config()
    assert a.rows > cfg.dense_cholesky_max_n
    sched = analyze_supernodal(a, relax=cfg.supernodal_relax)
    assert sched.avg_panel_width >= 2.0
    assert sched.nnz_l > analyze_supernodal(a, relax=0).nnz_l

    got = cholesky_auto(a).todense().numpy()
    ref = np.linalg.cholesky(dense.astype(np.float64))
    assert np.allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert np.allclose(got, np.asarray(j_auto(ja).todense()), rtol=1e-4,
                       atol=1e-4)


def test_assemble_factor_rejects_mismatched_values():
    from basic_sparse_matrix_tpu_torch.models import supernodal as sn

    a = CSR.from_dense(_lap2d(6))
    sched = sn.analyze_supernodal(a, relax=8)
    lvals = sn.factorize_supernodal(sched, a.values)
    assert lvals.shape[0] != sn.analyze_supernodal(a, relax=0).nnz_l
    with pytest.raises(ValueError, match="does not match"):
        sn.assemble_factor(a, lvals)   # sched-less rebuild must not truncate
    l = sn.assemble_factor(a, lvals, sched).todense().numpy()
    ref = np.linalg.cholesky(_lap2d(6).astype(np.float64))
    assert np.allclose(l, ref, rtol=1e-4, atol=1e-4)


def _block_diag(n=256, bs=8):
    d = np.zeros((n, n), dtype=np.float32)
    rng = np.random.default_rng(7)
    for b0 in range(0, n, bs):
        d[b0:b0 + bs, b0:b0 + bs] = rng.standard_normal((bs, bs))
    return d


def test_bsr_profitable_cached_branch_agrees():
    d = _block_diag()
    a, ja = CSR.from_dense(d), JCSR.from_dense(d)
    b = torch.zeros((256, 128))
    want = jk.bsr_profitable(ja, 128, force=True)
    assert pk.bsr_profitable(a, b) is False         # the device gate, on CPU
    assert pk.bsr_profitable(a, b, force=True) is want is True   # no cache
    out = pk.spmm_bsr_from_csr(a, b)                # sets the cache
    assert a._bsr_cache is not None and not out.any()
    assert pk.bsr_profitable(a, b, force=True) is True           # cached
    assert pk.bsr_profitable(a, b[:, :32], force=True) is False  # n < 64


_real_j_bsr_profitable = jk.bsr_profitable


def test_spmm_auto_bsr_branch_twice(monkeypatch):
    from basic_sparse_matrix_tpu.ops.spmm import spmm_auto as j_auto
    from basic_sparse_matrix_tpu_torch.ops.spmm import spmm, spmm_auto

    d = _block_diag()
    a, ja = CSR.from_dense(d), JCSR.from_dense(d)
    monkeypatch.setattr(
        jk, "bsr_profitable",
        lambda m, n: _real_j_bsr_profitable(m, n, force=True))
    b = np.random.default_rng(3).standard_normal((256, 64)).astype(
        np.float32)
    bt = torch.from_numpy(b)
    oracle = spmm(a, bt).numpy()
    want = np.asarray(j_auto(ja, b))     # as the JAX test drives its branch
    assert pk.bsr_profitable(a, bt, force=True)
    out1 = pk.spmm_bsr_from_csr(a, bt).numpy()
    assert a._bsr_cache is not None
    out2 = pk.spmm_bsr_from_csr(a, bt).numpy()      # from the cached layout
    for out in (out1, out2, spmm_auto(a, bt).numpy(),
                spmm_auto(a, bt).numpy()):
        assert np.allclose(out, oracle, rtol=1e-4, atol=1e-4)
        assert np.allclose(out, d @ b, rtol=1e-3, atol=1e-3)
        assert np.allclose(out, want, rtol=1e-4, atol=1e-4)
