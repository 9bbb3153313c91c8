"""The scatter-list Cholesky (``models/sparse_cholesky.py``), IC(0) and the
Cholesky entry points (``models/cholesky.py``) of the PyTorch port against
the JAX package on the CPU.

Mirrors ``test_sparse_solvers.py``, the IC(0) half of ``test_pcg.py`` and
the Cholesky goldens of ``test_solver.py`` on the same seeded numpy inputs.
Tolerances:

* schedule tables (pattern, triples per destination, column positions):
  exact (integers);
* the scatter-list factor: ``rtol=1e-5`` with ``atol=1e-6·max|ref|``
  against the JAX factor (each column's updates are applied in the same
  order, but XLA on the CPU may contract a multiply and an add into one
  fused operation); exact against the JAX schedule converted to the
  port's ragged layout;
* dense factors (``cholesky``) and factors through the ladder: ``rtol=1e-5``
  with ``atol=1e-5·max|ref|``;
* the reference goldens: ``rtol=1e-5``;
* solves through ``DirectSolver``'s scatter tier: ``rtol=1e-4`` with
  ``atol=1e-5·max|ref|`` (two float32 factorizations);
* a matrix that is not positive definite: NaN in the same positions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import sparse_cholesky as jsc
from basic_sparse_matrix_tpu.utils import config as jcfg
from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as psc
from basic_sparse_matrix_tpu_torch.ops import interop
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _laplacian_1d(n):
    return (4.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)).astype(
        np.float32)


def _laplacian_2d(k):
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


def _random_spd(rng, n, density=0.15):
    m = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
    return (m @ m.T + n * np.eye(n)).astype(np.float32)


def _tree_laplacian(n, seed):
    """Laplacian of a random recursive tree plus I (node i joins a uniformly
    random earlier node): a radial distribution grid's shape."""
    rng = np.random.default_rng(seed)
    par = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    ch = np.arange(1, n)
    deg = np.bincount(par, minlength=n) + np.bincount(ch, minlength=n)
    rows = np.concatenate([np.arange(n), ch, par])
    cols = np.concatenate([np.arange(n), par, ch])
    vals = np.concatenate([deg + 1.0, -np.ones(2 * (n - 1))])
    return n, rows, cols, vals.astype(np.float32)


def _case(name):
    rng = np.random.default_rng(1)
    return {
        "tridiag": lambda: _laplacian_1d(32),
        "lap2d": lambda: _laplacian_2d(6),
        "dense_spd": lambda: _random_spd(rng, 24, density=0.3),
        # sparse.rs:1031-1060 and :1063-1080
        "reference0": lambda: np.asarray(
            [[4.0, 12, -16], [12, 37, -43], [-16, -43, 98]], np.float32),
        "reference1": lambda: np.asarray(
            [[8.0, 0, 0, 0], [0, 7, 1, 0], [0, 1, 3, 0], [0, 0, 0, 2]],
            np.float32),
        "sparse_spd": lambda: _random_spd(rng, 40, density=0.05),
    }[name]()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _jax_levels(js):
    """Per level of a JAX schedule: its columns' diagonal positions and its
    live triples, without padding."""
    col_pos = np.asarray(js.col_pos)
    dst, ua, ub = (np.asarray(x) for x in (js.upd_dst, js.upd_a, js.upd_b))
    out = []
    for lv in range(col_pos.shape[0]):
        live = dst[lv] != js.nnz_l
        out.append((col_pos[lv, :, 0][col_pos[lv, :, 0] != js.nnz_l],
                    dst[lv][live], ua[lv][live], ub[lv][live]))
    return out


def _port_levels(ps):
    out = []
    for lv in range(ps.n_levels):
        u = slice(ps.upd_ptr[lv], ps.upd_ptr[lv + 1])
        out.append((ps.col_diag[ps.col_ptr[lv]: ps.col_ptr[lv + 1]].numpy(),
                    ps.upd_dst[u].numpy(), ps.upd_a[u].numpy(),
                    ps.upd_b[u].numpy()))
    return out


@pytest.fixture
def configs():
    jold, pold = jcfg.get_config(), pcfg.get_config()

    def set_both(**kw):
        jcfg.set_config(dataclasses.replace(jold, **kw))
        pcfg.set_config(dataclasses.replace(pold, **kw))
    yield set_both
    jcfg.set_config(jold)
    pcfg.set_config(pold)


# ---- schedule --------------------------------------------------------------
def _by_destination(levels):
    """Every triple in the order it is applied, then grouped by destination
    (stable): each position's updates in their order, whatever the levels."""
    dst, ua, ub = (np.concatenate([lv[i] for lv in levels]) for i in (1, 2, 3))
    order = np.argsort(dst, kind="stable")
    return dst[order], ua[order], ub[order]


def _convert(js):
    return interop.cholesky_schedule_from_numpy(
        js.a_src_pos, js.a_vals_idx, js.upd_dst, js.upd_a, js.upd_b,
        js.col_pos, js.l_col_ptr, js.l_row_idx, js.nnz_l, js.n)


@pytest.mark.parametrize("case", ["tridiag", "lap2d", "sparse_spd"])
@pytest.mark.parametrize("incomplete", [False, True])
def test_schedule_tables_match_jax(case, incomplete):
    """The pattern, the A-to-L scatter and the column pointers equal the
    JAX tables; every position receives the same updates in the same order;
    each update runs in its destination column's level, after both source
    columns were finalised. For the full factor the levels themselves are
    the JAX ones (the next test); for IC(0) they are fewer. Either way the
    factor equals, bit for bit, the one from the JAX schedule converted to
    the ragged layout."""
    d = _case(case)
    ja, pa = J.CSR.from_dense(d), P.CSR.from_dense(d)
    js = jsc.analyze(ja, incomplete=incomplete)
    ps = psc.analyze(pa, incomplete=incomplete)
    assert (ps.nnz_l, ps.n) == (js.nnz_l, js.n)
    assert np.array_equal(ps.l_col_ptr, js.l_col_ptr)
    assert np.array_equal(ps.l_row_idx, js.l_row_idx)
    assert np.array_equal(ps.a_src_pos.numpy(), np.asarray(js.a_src_pos))
    assert np.array_equal(ps.a_vals_idx.numpy(), np.asarray(js.a_vals_idx))
    assert ps.col_off.numel() == ps.nnz_l - ps.n
    pl = _port_levels(ps)
    for w, g in zip(_by_destination(_jax_levels(js)), _by_destination(pl)):
        assert np.array_equal(w, g)

    col_level = np.empty(ps.n, dtype=np.int64)
    for lv, (diag, *_) in enumerate(pl):
        col_level[np.searchsorted(ps.l_col_ptr, diag, side="right") - 1] = lv
    assert np.array_equal(np.sort(np.concatenate([p[0] for p in pl])),
                          ps.l_col_ptr[:-1])

    def level_of(pos):
        return col_level[np.searchsorted(ps.l_col_ptr, pos, side="right") - 1]
    for lv, (_, dst, ua, ub) in enumerate(pl):
        assert (level_of(dst) == lv).all()
        assert (level_of(ua) < lv).all() and (level_of(ub) < lv).all()
    assert torch.equal(psc.factorize(ps, pa.values),
                       psc.factorize(_convert(js), pa.values))


def test_pattern_levels_equal_etree_levels_for_the_full_factor():
    """For the full factor the level sets of L's pattern are the JAX
    package's elimination-tree levels: the ragged tables hold exactly the
    JAX padded tables' live entries, level by level."""
    d = _random_spd(np.random.default_rng(3), 50, density=0.06)
    js = jsc.analyze(J.CSR.from_dense(d))
    ps = psc.analyze(P.CSR.from_dense(d))
    jl, pl = _jax_levels(js), _port_levels(ps)
    assert len(jl) == len(pl) > 1
    for want, got in zip(jl, pl):
        for w, g in zip(want, got):
            assert np.array_equal(w, g)


def test_ic0_pattern_levels_are_fewer_and_factor_is_the_same():
    """IC(0) of the 12×12 grid Laplacian in natural order: the JAX
    schedule follows the etree, a chain of 144 levels; L's pattern has 23.
    The factor equals the converted JAX schedule's bit for bit, and the JAX
    factor within float32 round-off."""
    d = _laplacian_2d(12)
    a, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    fast = psc.analyze(a, incomplete=True)
    js = jsc.analyze(ja, incomplete=True)
    chain = _convert(js)
    assert (chain.n_levels, fast.n_levels) == (144, 23)
    want = np.asarray(jsc.factorize(js, ja.values))
    got = psc.factorize(fast, a.values)
    assert torch.equal(got, psc.factorize(chain, a.values))
    _close(got.numpy(), want)


# ---- numeric -----------------------------------------------------------------
@pytest.mark.parametrize("case", ["tridiag", "lap2d", "dense_spd",
                                  "reference0", "reference1", "sparse_spd"])
def test_factor_matches_jax(case):
    d = _case(case)
    pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    ps, js = psc.analyze(pa), jsc.analyze(ja)
    got = psc.factorize(ps, pa.values).numpy()
    want = np.asarray(jsc.factorize(js, ja.values))
    _close(got, want)
    # The JAX schedule converted to the ragged layout gives the same factor.
    assert np.array_equal(psc.factorize(_convert(js), pa.values).numpy(), got)
    l = psc.cholesky_sparse(pa).todense().numpy()
    np.testing.assert_allclose(l, np.asarray(jsc.cholesky_sparse(
        ja).todense()), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l, np.linalg.cholesky(d.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("incomplete", [False, True])
def test_not_positive_definite_nan_positions(incomplete):
    d = _laplacian_2d(4)
    d[5, 5] = -1.0
    pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    got = psc.factorize(psc.analyze(pa, incomplete=incomplete),
                        pa.values).numpy()
    want = np.asarray(jsc.factorize(jsc.analyze(ja, incomplete=incomplete),
                                    ja.values))
    assert np.isnan(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    _close(got[ok], want[ok])


def test_ic0_no_fill_and_exact_without_fill():
    d = _laplacian_2d(5)
    a = P.CSR.from_dense(d)
    s = psc.analyze(a, incomplete=True)
    lvals = psc.factorize(s, a.values).numpy()
    cols = np.repeat(np.arange(25), np.diff(s.l_col_ptr))
    assert (d[s.l_row_idx, cols] != 0)[lvals != 0].all()
    # tridiagonal: no fill, so IC(0) equals the full factor
    t = P.CSR.from_dense(_laplacian_1d(20))
    full = psc.factorize(psc.analyze(t), t.values).numpy()
    ic = psc.factorize(psc.analyze(t, incomplete=True), t.values).numpy()
    assert np.array_equal(full, ic)


def test_full_sparse_solve_pipeline_golden():
    """chol → forward → backward through the sparse level-scheduled path,
    the reference solve golden (lib.rs:120-138)."""
    from basic_sparse_matrix_tpu_torch.models.sparse_triangular import (
        solve_triangular_sparse,
    )

    a = P.CSR.from_dense(_case("reference1"))
    b = np.asarray([[5.0], [2.0], [8.0], [1.0]], dtype=np.float32)
    l = psc.cholesky_sparse(a)
    y = solve_triangular_sparse(l, b, lower=True)
    x = solve_triangular_sparse(l.transpose(), y, lower=False).numpy()
    np.testing.assert_allclose(x.ravel(), [0.625, -0.1, 2.6999998, 0.5],
                               rtol=1e-5)


# ---- DirectSolver's scatter tier ---------------------------------------------
@pytest.mark.parametrize("which", ["diagonal", "tree"])
def test_direct_solver_scatter_tier(configs, which):
    """A diagonal matrix (panels of width 1), and the Laplacian of a random
    recursive tree plus I under RCM (no fill, no band): both packages take
    the scatter-list tier and agree."""
    if which == "diagonal":
        configs(ordering="natural", banded_max_block=0)
        d = np.diag(np.arange(1.0, 51.0)).astype(np.float32)
        pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    else:
        # at this size the tree's RCM band would fit a block (not at 10⁵)
        configs(ordering="rcm", banded_max_block=0)
        n, r, c, v = _tree_laplacian(2000, seed=7)
        pa = P.CSR.from_coo_arrays((n, n), r, c, v)
        ja = J.CSR.from_coo_arrays((n, n), r, c, v)
        d = np.zeros((n, n))
        np.add.at(d, (r, c), v)
    n = d.shape[0]
    b = np.random.default_rng(9).standard_normal((n, 2)).astype(np.float32)
    ps, js = P.prepare_direct(pa), J.prepare_direct(ja)
    assert ps.kind == js.kind == "scatter"
    assert set(ps.timings) == {"order", "analyze", "numeric", "assemble",
                               "schedules"}
    got = ps.solve(b).numpy()
    want = np.asarray(js.solve(b))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(got, np.linalg.solve(d, b.astype(np.float64)),
                               rtol=1e-4, atol=1e-5 * scale)
    assert ps.solve(b[:, 0]).shape == (n,)


def test_tree_input_has_no_fill_and_no_band():
    """The tree at n = 10⁵ under RCM: no fill (n - 1 entries below the
    diagonal), no banded block, relaxed panels of average width ~1: the
    scatter-list tier's input."""
    from basic_sparse_matrix_tpu_torch.models import banded as pb
    from basic_sparse_matrix_tpu_torch.models import supernodal as psn
    from basic_sparse_matrix_tpu_torch.ops import reorder

    n, r, c, v = _tree_laplacian(100_000, seed=0)
    a = P.CSR.from_coo_arrays((n, n), r, c, v)
    a = reorder.permute_symmetric(a, reorder.rcm_permutation(a))
    assert pb.banded_block_choice(a) is None
    assert psn.supernode_stats(a, relax=8)[0] < 1.01
    s = psc.analyze(a)
    assert s.nnz_l == 2 * n - 1
    assert s.n_triples == n - 1


# ---- models/cholesky.py -----------------------------------------------------
def test_cholesky_golden_0():
    # sparse.rs:1031-1060: L = [[2,0,0],[6,1,0],[-8,5,3]]
    l = P.cholesky(P.CSR.from_dense(_case("reference0")))
    np.testing.assert_allclose(
        l.todense().numpy(), [[2, 0, 0], [6, 1, 0], [-8, 5, 3]], rtol=1e-5)
    np.testing.assert_allclose(
        l.transpose().todense().numpy(),
        [[2, 6, -8], [0, 1, 5], [0, 0, 3]], rtol=1e-5)


def test_cholesky_golden_1():
    # sparse.rs:1063-1080: 2.828427, 0.37796451, 1.6903086, 1.4142135
    m = _case("reference1")
    want = [[2.828427, 0, 0, 0], [0, 2.6457512, 0, 0],
            [0, 0.37796451, 1.6903086, 0], [0, 0, 0, 1.4142135]]
    for f in (P.cholesky, P.cholesky_decomp, P.cholesky_sparse):
        got = f(P.CSR.from_dense(m)).todense().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got = P.cholesky(P.CSR.from_dense(m))
    want = J.cholesky(J.CSR.from_dense(m))
    assert got.stored == want.stored
    np.testing.assert_allclose(got.todense().numpy(),
                               np.asarray(want.todense()), rtol=1e-6)


def test_cholesky_non_square_and_non_spd():
    with pytest.raises(P.NonSquareMatrix):
        P.cholesky(P.CSR.from_dense([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    with pytest.raises(P.NonSquareMatrix):
        P.cholesky_auto(P.CSR.from_dense(np.ones((2, 3), np.float32)))
    bad = np.asarray([[1.0, 2, 0], [2, 1, 0], [0, 0, 3]], np.float32)
    got = P.cholesky_dense(torch.as_tensor(bad)).numpy()
    want = np.asarray(J.cholesky_dense(bad))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    gl, jl = P.cholesky(P.CSR.from_dense(bad)), J.cholesky(J.CSR.from_dense(bad))
    assert gl.stored == jl.stored
    # a batch: only the failed member is NaN
    good = np.asarray([[4.0, 2, 0], [2, 5, 0], [0, 0, 3]], np.float32)
    out = P.cholesky_dense(torch.as_tensor(np.stack([good, bad]))).numpy()
    np.testing.assert_allclose(out[0], np.linalg.cholesky(good), rtol=1e-6)
    assert np.array_equal(np.isnan(out[1]), np.isnan(want))


@pytest.mark.parametrize("rung", ["dense", "banded", "supernodal", "scatter"])
def test_cholesky_auto_ladder(configs, rung):
    """Each rung of the ladder, reached the same way in both packages."""
    if rung == "dense":
        d = _random_spd(np.random.default_rng(4), 30, density=0.3)
    elif rung == "banded":
        configs(dense_cholesky_max_n=16, dense_cholesky_min_density=1.0,
                banded_min_steps=2)
        d = _laplacian_1d(96)
    elif rung == "supernodal":
        configs(dense_cholesky_max_n=16, dense_cholesky_min_density=1.0,
                banded_max_block=0)
        d = _laplacian_2d(7)
    else:
        configs(dense_cholesky_max_n=16, dense_cholesky_min_density=1.0,
                banded_max_block=0, supernodal_relax=0)
        d = _random_spd(np.random.default_rng(5), 60, density=0.02)
    got = P.cholesky_auto(P.CSR.from_dense(d)).todense().numpy()
    want = np.asarray(J.cholesky_auto(J.CSR.from_dense(d)).todense())
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, np.linalg.cholesky(d.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)
