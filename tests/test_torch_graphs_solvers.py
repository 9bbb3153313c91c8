"""The port's remaining single-device loops as compiled programs
(``runtime/graphs.py``): Lanczos' steps, the banded scan and BCR solves
and the QR eigen-iteration, and the direct solver's permutations kept on
the solver's device.

On the CPU ``graphs.run`` calls its function directly, so these cases hold
the restructured entry points against the JAX package, each called twice on
one owner with different inputs (the second call is the one that would
replay on the card), inputs from a seed with numpy:

* ``_lanczos_scan`` at k = 16 on the 8³ Laplacian, two start vectors on
  one set-up (its ELL view and its CSR), against JAX's: the tridiagonal
  within ``rtol=1e-5``, ``atol=1e-5·max|ref|``, the basis within
  ``atol=1e-4·max|ref|`` (``test_torch_iterative.py``'s bounds);
* the banded scan and BCR solves at 1 and 8 right-hand sides, two solves
  on one prepared solver, against JAX's ``solve_factored_banded`` and
  ``BCRSolver.solve`` within ``rtol=1e-4``, ``atol=1e-5·max|ref|`` (the
  solver bounds of ``test_torch_banded.py``);
* ``eigen_values_dense`` against JAX's within ``rtol=1e-4`` and
  ``atol=1e-4·max|ref|`` (``test_torch_qr.py``'s);
* ``DirectSolver.solve`` on the 14³ Laplacian under RCM (a banded tier) and
  ND (the supernodal tier), 1 and 8 right-hand sides: bit for bit the
  solve through the host permutation (the path before the permutations
  moved to the device), and JAX's within the solver bounds.

The ``cuda``-marked cases run on the card: each path's capture (on the
first call for the solves, the second for Lanczos and QR) and replays
against the eager loop within ``1e-5·max|ref|``, and a solve that uploads
no permutation.
"""

import dataclasses

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.models import banded as pb
from basic_sparse_matrix_tpu_torch.models import bcr as pbcr
from basic_sparse_matrix_tpu_torch.models import lanczos as pl
from basic_sparse_matrix_tpu_torch.models import qr as pqr
from basic_sparse_matrix_tpu_torch.models import sparse_triangular as pst
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.runtime import graphs
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

REPLAY_ATOL_OF_MAX = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def jax_pkg():
    """The JAX package (the reference of the CPU cases)."""
    return pytest.importorskip("basic_sparse_matrix_tpu")


def _lap(k, dim=3):
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


def _dense(k, dim=3):
    n, r, c, v = _lap(k, dim)
    d = np.zeros((n, n), dtype=np.float32)
    np.add.at(d, (r, c), v)
    return d


def _banded_spd(rng, n, bw):
    """A random symmetric band of half-width ``bw``, diagonally dominant."""
    d = np.zeros((n, n), np.float32)
    for o in range(1, bw + 1):
        x = rng.standard_normal(n - o).astype(np.float32)
        d += np.diag(x, o) + np.diag(x, -o)
    d += np.diag(np.abs(d).sum(1) + 1.0 + rng.random(n)).astype(np.float32)
    return d


def _close(got, want, rtol=1e-5, atol_of_max=1e-5):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol_of_max * max(float(np.abs(want).max(initial=0.0)), 1e-30))


# ---- Lanczos ----------------------------------------------------------------
@pytest.mark.parametrize("view", ["ell", "csr"])
def test_lanczos_scan_twice_on_one_setup_matches_jax(jax_pkg, view):
    from basic_sparse_matrix_tpu.models import lanczos as jl

    d = _dense(8)
    pa, ja = P.CSR.from_dense(d), jax_pkg.CSR.from_dense(d)
    setup = pl.LanczosSetup.build(pa)
    assert setup.ell is not None
    if view == "csr":
        setup = pl.LanczosSetup(a=pa)
    jsetup = jl.LanczosSetup.build(ja)
    rng = np.random.default_rng(12)
    for _ in range(2):
        v0 = rng.standard_normal(512).astype(np.float32)
        a, b, V = pl._lanczos_scan(setup, torch.as_tensor(v0), 16)
        ja_, jb_, jV = jl._lanczos_scan(jsetup, v0, 16)
        _close(a, ja_)
        _close(b, jb_)
        _close(V, jV, atol_of_max=1e-4)
        _close(pl._ritz_values(setup, torch.as_tensor(v0), 16),
               jl._ritz_values(jsetup, v0, 16), rtol=1e-4)
    assert graphs.count(setup) == 0 and graphs.calls(setup) == 0


# ---- banded scan and BCR solves -------------------------------------------
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("tier", ["banded", "bcr"])
def test_two_banded_solves_on_one_solver_match_jax(jax_pkg, tier, k):
    from basic_sparse_matrix_tpu.models import banded as jb
    from basic_sparse_matrix_tpu.models import bcr as jbcr

    rng = np.random.default_rng(40 + k)
    d = _banded_spd(rng, 90, 6)
    pa, ja = P.CSR.from_dense(d), jax_pkg.CSR.from_dense(d)
    if tier == "banded":
        ps, js = pb.factor_banded(pa, 8), jb.factor_banded(ja, 8)
        psolve = lambda b: pb.solve_factored_banded(ps, b)      # noqa: E731
        jsolve = lambda b: jb.solve_factored_banded(js, b)      # noqa: E731
    else:
        ps, js = pbcr.prepare_bcr(pa, 8), jbcr.prepare_bcr(ja, 8)
        psolve, jsolve = ps.solve, js.solve
    for _ in range(2):
        b = rng.standard_normal((90, k) if k > 1 else 90).astype(np.float32)
        got = psolve(torch.as_tensor(b))
        _close(got, jsolve(b), rtol=1e-4)
        _close(got, np.linalg.solve(d.astype(np.float64), b), rtol=1e-4,
               atol_of_max=1e-4)
    assert graphs.count(ps) == 0


# ---- the QR eigen-iteration -----------------------------------------------
@pytest.mark.parametrize("iterations", [0, 10, 60])
def test_eigen_values_dense_twice_matches_jax(jax_pkg, iterations):
    from basic_sparse_matrix_tpu.models import qr as jqr

    rng = np.random.default_rng(iterations)
    for _ in range(2):
        m = rng.standard_normal((24, 24)).astype(np.float32)
        a = (m + m.T) / 2 + np.diag(np.arange(24.0, dtype=np.float32))
        got = pqr.eigen_values_dense(torch.as_tensor(a), iterations)
        _close(got, jqr.eigen_values_dense(a, iterations), rtol=1e-4,
               atol_of_max=1e-4)
    assert graphs.count(pqr._QR_ITERATION) == 0


# ---- the direct solver's permutations on the device -------------------------
@pytest.fixture(scope="module")
def lap14_solvers():
    """The 14³ Laplacian's direct solvers under RCM and ND in both
    packages (module scope: the JAX supernodal numeric phase compiles
    once)."""
    jax_pkg = pytest.importorskip("basic_sparse_matrix_tpu")
    from basic_sparse_matrix_tpu.utils import config as jcfg

    n, r, c, v = _lap(14)
    out = {}
    jold, pold = jcfg.get_config(), pcfg.get_config()
    try:
        for ordering in ("rcm", "nd"):
            for cfg, old in ((jcfg, jold), (pcfg, pold)):
                cfg.set_config(dataclasses.replace(old, ordering=ordering))
            out[ordering] = (
                P.DirectSolver(P.CSR.from_coo_arrays((n, n), r, c, v)),
                jax_pkg.DirectSolver(jax_pkg.CSR.from_coo_arrays(
                    (n, n), r, c, v)))
    finally:
        jcfg.set_config(jold)
        pcfg.set_config(pold)
    return out


def _host_permuted_solve(solver, b):
    """``DirectSolver.solve`` as it ran with the permutation on the host:
    inverted in numpy and uploaded at each call."""
    rhs = b[:, None] if b.ndim == 1 else b
    rhs = pr.apply_perm(rhs, solver.perm)
    if solver.kind == "banded-bcr":
        x = solver._banded.solve(rhs)
    elif solver.kind == "banded":
        x = pb.solve_factored_banded(solver._banded, rhs)
    else:
        y = pst.solve_triangular_sparse(solver._l, rhs, solver._fwd)
        x = pst.solve_triangular_sparse(solver._l, y, solver._bwd,
                                        lower=False)
    x = pr.apply_perm(x, solver.perm, inverse=True)
    return x[:, 0] if b.ndim == 1 else x


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_device_permutations_are_the_host_ones(lap14_solvers, ordering, k):
    ps, js = lap14_solvers[ordering]
    assert ps.kind == js.kind
    assert ps.kind == ("supernodal" if ordering == "nd" else "banded-bcr")
    assert np.array_equal(ps.perm, js.perm)
    to_p, from_p = ps._gathers
    assert to_p.dtype == from_p.dtype == torch.int64
    assert to_p.device == from_p.device == ps.device
    rng = np.random.default_rng(k)
    b = rng.standard_normal((ps.n, k) if k > 1 else ps.n).astype(np.float32)
    got = ps.solve(torch.as_tensor(b))
    assert torch.equal(got, _host_permuted_solve(ps, torch.as_tensor(b)))
    _close(got, js.solve(b), rtol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_perm_takes_a_tensor(inverse):
    perm = np.random.default_rng(3).permutation(50)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((50, 3))
                        .astype(np.float32))
    want = pr.apply_perm(x, perm, inverse=inverse)
    for p in (torch.as_tensor(perm), torch.as_tensor(perm.astype(np.int32))):
        assert torch.equal(pr.apply_perm(x, p, inverse=inverse), want)


def test_a_loaded_solver_keeps_its_gathers(tmp_path):
    n, r, c, v = _lap(6)
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="rcm"))
    try:
        solver = P.DirectSolver(P.CSR.from_coo_arrays((n, n), r, c, v))
    finally:
        pcfg.set_config(old)
    from basic_sparse_matrix_tpu_torch.runtime import checkpoint

    path = str(tmp_path / "solver.npz")
    checkpoint.save_direct(path, solver)
    loaded = checkpoint.load_direct(path, device="cpu")
    assert np.array_equal(loaded.perm, solver.perm)
    for got, want in zip(loaded._gathers, solver._gathers):
        assert torch.equal(got, want)
    b = torch.as_tensor(np.random.default_rng(5).standard_normal(n)
                        .astype(np.float32))
    assert torch.equal(loaded.solve(b), solver.solve(b))


# ---- on the card ------------------------------------------------------------
def _near(got, want):
    assert got.shape == want.shape and want.numel()
    assert float((got - want).abs().max()) \
        <= REPLAY_ATOL_OF_MAX * float(want.abs().max())


def _rhs(seed, shape, device):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32), device=device)


@pytest.mark.cuda
def test_lanczos_captures_on_its_second_call(cuda):
    setup = pl.LanczosSetup.build(P.CSR.from_dense(_dense(8), device=cuda))
    counts = []
    for seed in (1, 2, 3):
        v0 = _rhs(seed, 512, cuda)
        got = pl._lanczos_scan(setup, v0, 16)
        counts.append(graphs.count(setup))
        want = pl._lanczos_steps(setup, 16, v0)
        for g, w in zip(got, want):
            _near(g, w)
    assert counts == [0, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("tier", ["banded", "bcr"])
def test_banded_solves_capture_on_their_first_call(cuda, tier, k):
    d = _banded_spd(np.random.default_rng(7), 200, 9)
    a = P.CSR.from_dense(d, device=cuda)
    solver = (pb.factor_banded(a, 16) if tier == "banded"
              else pbcr.prepare_bcr(a, 16))
    for seed in (1, 2):
        b = _rhs(seed, (200, k) if k > 1 else 200, cuda)
        if tier == "banded":
            got = pb.solve_factored_banded(solver, b)
            blocks, _ = pb._blocked_rhs(b, solver.n, solver.m, solver.nb,
                                        cuda)
            want = pb.solve_banded_blocks(solver.L, solver.F, blocks)
        else:
            got = solver.solve(b)
            m = -(-solver.n // solver.nb)
            blocks, _ = pb._blocked_rhs(b, solver.n, m, solver.nb, cuda)
            blocks = torch.nn.functional.pad(
                blocks, (0, 0, 0, 0, 0, solver.fac.m_padded - m))
            want = pbcr._solve_refined(solver.fac, solver.D, solver.E,
                                       blocks)
        want = want.reshape(-1, k)[:200]
        _near(got.reshape(200, k), want)
        assert graphs.count(solver) == 1


@pytest.mark.cuda
def test_the_qr_iteration_captures_on_its_second_call(cuda):
    counts = []
    for seed in (1, 2, 3):
        m = _rhs(seed, (64, 64), cuda)
        a = (m + m.T) / 2 + torch.diag(torch.arange(64.0, device=cuda))
        got = pqr.eigen_values_dense(a, 30)
        counts.append(graphs.count(pqr._QR_ITERATION))
        _near(got, pqr._qr_iterate(30, a))
    assert counts[1] == counts[0] + 1 and counts[2] == counts[1]


@pytest.mark.cuda
def test_a_solve_uploads_no_permutation(cuda):
    """After the first solve of a shape (the capture), a solve's device
    work holds no host-to-device copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n, r, c, v = _lap(6)
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ordering="rcm",
                                        banded_max_block=0))
    try:
        solver = P.DirectSolver(P.CSR.from_coo_arrays((n, n), r, c, v,
                                                      device=cuda))
    finally:
        pcfg.set_config(old)
    assert solver.perm is not None and solver.kind in ("supernodal",
                                                       "scatter")
    b = _rhs(3, (n, 2), cuda)
    want = solver.solve(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = solver.solve(b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert names and not [nm for nm in names if "HtoD" in nm]
    _near(got, want)
