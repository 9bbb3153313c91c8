"""The direct-solver slice of the PyTorch port against the JAX package on the
CPU.

* The ragged level-scheduled ``solve_triangular_sparse`` against the JAX
  padded one on the same factor, lower and upper (mirrored), 1 and 3
  right-hand sides: ``rtol=1e-5``, ``atol=1e-6·max|ref|`` (float32 sums in
  another order). Its tables grow with nnz, not with levels × rows × deps.
  The level-step kernel's launch plan covers every level once, in order,
  within its narrow limits, and the CPU solve still equals JAX's.
* ``DirectSolver`` / ``solve_sparse`` end to end under ``ordering`` nd, rcm
  and auto (the banded tier switched off where it would be picked, in both
  packages) against the JAX solution, ``rtol=1e-4`` with ``atol=1e-5·max``
  (two float32 factorizations and four triangular solves), and against a
  float64 solve.
* The reference goldens (forward/backward substitution, ``solve`` with
  x = [0.625, -0.1, 2.6999998, 0.5], multi-RHS) through the port's
  ``models/triangular.py`` and ``solve``, ``rtol=1e-5``.
* The banded tiers (the 8³ Laplacian under RCM: ``banded-bcr`` and, with
  ``banded_solver="scan"``, ``banded``) and the scatter-list tier (a
  diagonal matrix, panels of width 1): the same ``kind`` as the JAX
  ``DirectSolver`` and the same solution, ``rtol=1e-4`` with
  ``atol=1e-5·max``; the port runs with ``jax`` blocked.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import sparse_triangular as jst
from basic_sparse_matrix_tpu.utils import config as jcfg
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield

ROOT = Path(__file__).resolve().parent.parent


def _lap(k, dim):
    """The (2·dim+1)-point Laplacian on a k^dim grid as COO arrays."""
    n = k ** dim
    idx = np.arange(n).reshape((k,) * dim)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 2.0 * dim)]
    for ax in range(dim):
        a = np.take(idx, range(k - 1), axis=ax).ravel()
        b = np.take(idx, range(1, k), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    return (n, np.concatenate(r), np.concatenate(c),
            np.concatenate(v).astype(np.float32))


def _dense(n, r, c, v):
    d = np.zeros((n, n))
    np.add.at(d, (r, c), v)
    return d


@pytest.fixture
def configs():
    """Set the same config fields in both packages; restore both after."""
    jold, pold = jcfg.get_config(), pcfg.get_config()

    def set_both(**kw):
        jcfg.set_config(dataclasses.replace(jold, **kw))
        pcfg.set_config(dataclasses.replace(pold, **kw))
    yield set_both
    jcfg.set_config(jold)
    pcfg.set_config(pold)


def _factor(seed, n, density):
    """A random well-conditioned lower-triangular factor with a full
    diagonal, as a port CSR and a JAX CSR."""
    rng = np.random.default_rng(seed)
    d = np.tril((rng.random((n, n)) < density)
                * rng.standard_normal((n, n)), -1)
    d += np.diag(rng.uniform(1.0, 2.0, n))
    d = d.astype(np.float32)
    return P.CSR.from_dense(d), J.CSR.from_dense(d), d


@pytest.mark.parametrize("seed,n,density", [(0, 60, 0.1), (1, 200, 0.03),
                                            (2, 1, 1.0), (3, 90, 0.5)])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_solve_triangular_sparse_matches_jax(seed, n, density, lower, k):
    pl, jl, d = _factor(seed, n, density)
    if not lower:
        pl, jl, d = pl.transpose(), jl.transpose(), d.T
    b = np.random.default_rng(seed + 10).standard_normal((n, k)).astype(
        np.float32)
    ps = pst.build_schedule(pl, lower=lower)
    js = jst.build_schedule(jl, lower=lower)
    assert ps.n_levels == js.rows_by_level.shape[0]
    got = pst.solve_triangular_sparse(pl, torch.as_tensor(b), ps,
                                      lower=lower).numpy()
    want = np.asarray(jst.solve_triangular_sparse(jl, b, js, lower=lower))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, np.linalg.solve(d.astype(np.float64), b),
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_schedule_levels_match_jax_and_stay_ragged(configs):
    """Same level sets as the JAX schedule on an ND-ordered Laplacian
    factor; the port's tables hold each off-diagonal entry once (the JAX
    tables are padded to levels × max rows × max deps)."""
    configs(ordering="nd", banded_max_block=0)
    n, r, c, v = _lap(6, 3)
    pl = P.prepare_direct(P.CSR.from_coo_arrays((n, n), r, c, v))._l
    indptr, indices, values = pl.numpy()
    jl = J.CSR.from_coo_arrays(
        (n, n), np.repeat(np.arange(n), np.diff(indptr)), indices, values,
        sum_duplicates=False, drop_zeros=False)
    ps, js = pst.build_schedule(pl), jst.build_schedule(jl)
    rbl = np.asarray(js.rows_by_level)
    for lv in range(ps.n_levels):
        rows = ps.rows[ps.row_ptr[lv]: ps.row_ptr[lv + 1]].numpy()
        assert np.array_equal(rows, rbl[lv][rbl[lv] < n])
    off = pl.stored - n
    assert ps.cols.numel() == ps.vals.numel() == ps.seg.numel() == off
    assert np.asarray(js.dep_vals).size > 5 * off
    b = np.random.default_rng(6).standard_normal((n, 2)).astype(np.float32)
    want = np.asarray(jst.solve_triangular_sparse(jl, b, js))
    np.testing.assert_allclose(
        pst.solve_triangular_sparse(pl, torch.as_tensor(b), ps).numpy(),
        want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("limits", [(256, 12288), (3, 60)])
@pytest.mark.parametrize("lower", [True, False])
def test_launch_plan_covers_every_level_once(configs, monkeypatch, limits,
                                             lower):
    """The level-step kernel's plan on the 7³ Laplacian's ND factor, at the
    port's narrow limits and at small ones (wide launches and runs mixed):
    every level once and in order, each run maximal and within both
    limits, each wide launch one wider level. The CPU solve, which the plan
    does not touch, still equals the JAX package's."""
    monkeypatch.setattr(pst, "NARROW_ROWS", limits[0])
    monkeypatch.setattr(pst, "NARROW_ENTRIES", limits[1])
    configs(ordering="nd", banded_max_block=0)
    n, r, c, v = _lap(7, 3)
    pl = P.prepare_direct(P.CSR.from_coo_arrays((n, n), r, c, v))._l
    indptr, indices, values = pl.numpy()
    jl = J.CSR.from_coo_arrays(
        (n, n), np.repeat(np.arange(n), np.diff(indptr)), indices, values,
        sum_duplicates=False, drop_zeros=False)
    if not lower:
        pl, jl = pl.transpose(), jl.transpose()
    ps = pst.build_schedule(pl, lower=lower)
    rows, ents = np.diff(ps.row_ptr), np.diff(ps.ent_ptr)
    narrow = (rows <= limits[0]) & (ents <= limits[1])
    plan = ps.plan
    assert plan[0, 0] == 0 and plan[-1, 1] == ps.n_levels
    assert np.array_equal(plan[1:, 0], plan[:-1, 1])
    for lv0, lv1, blocks in plan:
        assert lv1 > lv0
        if blocks == 0:
            assert narrow[lv0:lv1].all()
            assert (lv0 == 0 or not narrow[lv0 - 1]) \
                and (lv1 == ps.n_levels or not narrow[lv1])
        else:
            assert lv1 == lv0 + 1 and not narrow[lv0]
    if limits[0] < 256:
        assert len(set(np.sign(plan[:, 2]))) == 2
    b = np.random.default_rng(9).standard_normal((n, 2)).astype(np.float32)
    want = np.asarray(jst.solve_triangular_sparse(
        jl, b, jst.build_schedule(jl, lower=lower), lower=lower))
    np.testing.assert_allclose(
        pst.solve_triangular_sparse(pl, torch.as_tensor(b), ps,
                                    lower=lower).numpy(),
        want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_missing_diagonal_raises():
    d = np.asarray([[1.0, 0], [1.0, 0]], np.float32)
    with pytest.raises(P.IncorrectDimensions):
        pst.build_schedule(P.CSR.from_dense(d))


@pytest.mark.parametrize("ordering", ["nd", "rcm", "auto"])
def test_direct_solver_matches_jax(configs, ordering):
    """The 7³ Laplacian (n = 343); the banded tier is switched off in both
    packages so every ordering reaches the supernodal tier."""
    configs(ordering=ordering, banded_max_block=0)
    n, r, c, v = _lap(7, 3)
    b = np.random.default_rng(4).standard_normal((n, 2)).astype(np.float32)
    ps = P.prepare_direct(P.CSR.from_coo_arrays((n, n), r, c, v))
    js = J.prepare_direct(J.CSR.from_coo_arrays((n, n), r, c, v))
    assert ps.kind == js.kind == "supernodal"
    got = ps.solve(b).numpy()
    want = np.asarray(js.solve(b))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    ref = np.linalg.solve(_dense(n, r, c, v), b.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)
    # 1-D in, 1-D out; a Dense right-hand side keeps its columns.
    x1 = ps.solve(b[:, 0])
    assert x1.shape == (n,)
    np.testing.assert_allclose(x1.numpy(), got[:, 0], rtol=1e-6, atol=1e-7)
    assert ps.solve(P.Dense(b[:, :1])).shape == (n, 1)
    assert set(ps.timings) == {"order", "analyze", "numeric", "assemble",
                               "schedules"}


def test_solve_sparse_2d_nd(configs):
    configs(ordering="nd")
    n, r, c, v = _lap(20, 2)
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    got = P.solve_sparse(P.CSR.from_coo_arrays((n, n), r, c, v), b)
    ref = np.linalg.solve(_dense(n, r, c, v), b.astype(np.float64))
    assert got.shape == (n, 1)
    np.testing.assert_allclose(got.numpy()[:, 0], ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_solve_auto_picks_dense_or_sparse(configs):
    n, r, c, v = _lap(6, 2)
    a = P.CSR.from_coo_arrays((n, n), r, c, v)
    b = np.ones((n, 1), np.float32)
    ref = np.linalg.solve(_dense(n, r, c, v), b.astype(np.float64))
    np.testing.assert_allclose(P.solve_auto(a, b).numpy(), ref, rtol=1e-5)
    configs(dense_cholesky_max_n=0, dense_cholesky_min_density=1.0,
            ordering="nd", banded_max_block=0)
    np.testing.assert_allclose(P.solve_auto(a, b).numpy(), ref, rtol=1e-4)


@pytest.mark.parametrize("backend,kind", [("bcr", "banded-bcr"),
                                          ("scan", "banded")])
def test_banded_tiers_match_jax(configs, backend, kind):
    """The 8³ Laplacian under RCM takes a banded tier in both packages."""
    configs(ordering="rcm", banded_solver=backend)
    n, r, c, v = _lap(8, 3)
    b = np.random.default_rng(8).standard_normal((n, 3)).astype(np.float32)
    ps = P.DirectSolver(P.CSR.from_coo_arrays((n, n), r, c, v))
    js = J.DirectSolver(J.CSR.from_coo_arrays((n, n), r, c, v))
    assert ps.kind == js.kind == kind
    assert np.array_equal(ps.perm, js.perm)
    got = ps.solve(b).numpy()
    want = np.asarray(js.solve(b))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    ref = np.linalg.solve(_dense(n, r, c, v), b.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)
    assert ps.solve(b[:, 0]).shape == (n,)


def test_scatter_tier_matches_jax(configs):
    """A diagonal matrix has panels of width 1: the scatter-list tier in
    both packages."""
    configs(ordering="natural", banded_max_block=0)
    d = np.diag(np.arange(1.0, 51.0)).astype(np.float32)
    b = np.random.default_rng(9).standard_normal((50, 2)).astype(np.float32)
    from basic_sparse_matrix_tpu_torch.models import supernodal as psn

    a = P.CSR.from_dense(d)
    assert psn.supernode_stats(a, relax=8)[0] < 2.0
    ps, js = P.DirectSolver(a), J.DirectSolver(J.CSR.from_dense(d))
    assert ps.kind == js.kind == "scatter"
    got = ps.solve(b).numpy()
    np.testing.assert_allclose(got, np.asarray(js.solve(b)), rtol=1e-4,
                               atol=1e-5 * np.abs(got).max())
    np.testing.assert_allclose(got, b / np.diag(d)[:, None], rtol=1e-6)


def test_reference_goldens_forward_backward():
    # lib.rs:74-94 — y = [7/5, -4.1, 25.5]
    y = P.forward_substitution(
        P.CSR.from_dense([[5.0, 0.0, 0.0], [8.0, 2.0, 0.0],
                          [3.0, 7.0, 1.0]]),
        P.Dense.from_data([[7.0, 3.0, 1.0]]))
    np.testing.assert_allclose(y.numpy().ravel(), [7 / 5, -4.1, 25.5],
                               rtol=1e-5)
    # lib.rs:97-117 — x = [-32/35, 2.6, 0.6]
    x = P.backward_substitution(
        P.CSR.from_dense([[7.0, 1.0, 8.0], [0.0, 2.0, 3.0],
                          [0.0, 0.0, 5.0]]),
        P.Dense.from_data([[1.0, 7.0, 3.0]]))
    np.testing.assert_allclose(x.numpy().ravel(), [-32 / 35, 2.6, 0.6],
                               rtol=1e-5)


_A4 = [[8.0, 0.0, 0.0, 0.0], [0.0, 7.0, 1.0, 0.0], [0.0, 1.0, 3.0, 0.0],
       [0.0, 0.0, 0.0, 2.0]]


def test_reference_golden_solve():
    # lib.rs:120-138 — x = [0.625, -0.1, 2.6999998, 0.5]
    a = P.CSR.from_dense(_A4)
    b = P.Dense.from_data([[5.0, 2.0, 8.0, 1.0]])
    x = P.solve(a, b)
    np.testing.assert_allclose(x.numpy().ravel(),
                               [0.625, -0.1, 2.6999998, 0.5], rtol=1e-5)
    np.testing.assert_allclose(
        x.numpy().ravel(),
        np.asarray(J.solve(J.CSR.from_dense(_A4),
                           J.Dense.from_data([[5.0, 2.0, 8.0, 1.0]]))).ravel(),
        rtol=1e-6)


def test_solve_multi_rhs_and_non_spd():
    rng = np.random.default_rng(5)
    m = rng.standard_normal((6, 6))
    a_dense = (m @ m.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.standard_normal((6, 3)).astype(np.float32)
    x = P.solve(P.CSR.from_dense(a_dense), b).numpy()
    np.testing.assert_allclose(a_dense @ x, b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        x, np.asarray(J.solve(J.CSR.from_dense(a_dense), b)), rtol=1e-5,
        atol=1e-6)
    bad = np.asarray([[1.0, 2.0], [2.0, 1.0]], np.float32)
    assert np.isnan(P.solve(P.CSR.from_dense(bad), np.ones(2)).numpy()).all()
    with pytest.raises(P.NonSquareMatrix):
        P.solve(P.CSR.from_dense(np.ones((2, 3), np.float32)), np.ones(2))
    with pytest.raises(P.IncorrectDimensions):
        P.solve(P.CSR.from_dense(a_dense), np.ones(5))


_BLOCKED = (
    "import sys\n"
    "sys.modules['jax'] = None\n"
    "import numpy as np, dataclasses\n"
    "import basic_sparse_matrix_tpu_torch as P\n"
    "from basic_sparse_matrix_tpu_torch.utils import config\n"
    "config.set_config(dataclasses.replace(config.get_config(),"
    " ordering='nd', banded_max_block=0, device='cpu'))\n"
    "k = 6; n = k * k; d = 4 * np.eye(n)\n"
    "for i in range(n):\n"
    "    for j in (i + 1, i + k):\n"
    "        if j < n and (j != i + 1 or j % k):\n"
    "            d[i, j] = d[j, i] = -1\n"
    "x = P.solve_sparse(P.CSR.from_dense(d.astype(np.float32)), np.ones(n))\n"
    "assert np.allclose(d @ x.numpy()[:, 0], 1, atol=1e-4)\n"
    "print('ok')\n"
)


def test_port_solves_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
