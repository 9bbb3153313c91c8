"""The port's ``runtime/{validate,io,checkpoint,profiling}.py`` against the
JAX package on the CPU.

State is carried across through files: a Matrix Market file written by
either package must read back in the other (and the two writers' bytes are
equal); ``.npz`` checkpoints written by the JAX package (CSR, banded scan
and BCR factors, prepared direct solvers, a partial factorization) load in
the port, and the loaded solver's solution is held to the JAX solver's at
``rtol=1e-5`` with ``atol`` 1e-5 of the largest magnitude (two float32
solves in different summation orders).
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu.runtime.checkpoint as jck
import basic_sparse_matrix_tpu.runtime.io as jio
import basic_sparse_matrix_tpu.runtime.validate as jval
import basic_sparse_matrix_tpu.utils.config as jcfg
import basic_sparse_matrix_tpu_torch as P
import basic_sparse_matrix_tpu_torch.runtime.checkpoint as pck
import basic_sparse_matrix_tpu_torch.runtime.io as pio
import basic_sparse_matrix_tpu_torch.runtime.profiling as prof
import basic_sparse_matrix_tpu_torch.runtime.validate as pval
import basic_sparse_matrix_tpu_torch.utils.config as pcfg
from basic_sparse_matrix_tpu_torch.ops import interop
from basic_sparse_matrix_tpu_torch.utils.errors import (
    IncorrectDimensions,
    MatErr,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield
DATA = os.path.join(os.path.dirname(__file__), "data")


def _sparse(seed, rows, cols, density=0.2):
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


def _same_csr(p, j):
    assert p.shape == j.shape
    assert np.array_equal(p.indptr.numpy(), np.asarray(j.indptr))
    assert np.array_equal(p.indices.numpy(), np.asarray(j.indices))
    assert np.array_equal(p.values.numpy(), np.asarray(j.values))


def _close(x, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


# ---- validate ---------------------------------------------------------------
def _broken(kind):
    """A CSR triple that breaks one structural invariant; built as raw
    arrays so both packages can wrap them unchecked."""
    indptr = np.asarray([0, 2, 3], np.int32)
    indices = np.asarray([0, 2, 1], np.int32)
    values = np.asarray([1.0, 2.0, 3.0], np.float32)
    if kind == "endpoint":
        indptr = np.asarray([0, 2, 2], np.int32)
    elif kind == "monotone":
        indptr = np.asarray([0, 4, 3], np.int32)
    elif kind == "range":
        indices = np.asarray([0, 5, 1], np.int32)
    elif kind == "unsorted":
        indices = np.asarray([2, 0, 1], np.int32)
    elif kind == "duplicates":
        indices = np.asarray([1, 1, 1], np.int32)
    return indptr, indices, values


def _raw_port(indptr, indices, values, shape=(2, 3)):
    return P.CSR(indptr=torch.from_numpy(indptr.copy()),
                 indices=torch.from_numpy(indices.copy()),
                 values=torch.from_numpy(values.copy()),
                 rows=shape[0], cols=shape[1])


def _raw_jax(indptr, indices, values, shape=(2, 3)):
    import jax.numpy as jnp

    return J.CSR(indptr=jnp.asarray(indptr), indices=jnp.asarray(indices),
                 values=jnp.asarray(values), rows=shape[0], cols=shape[1])


@pytest.mark.parametrize("kind,kw,bad", [
    ("ok", {}, False),
    ("endpoint", {}, True),
    ("monotone", {}, True),
    ("range", {}, True),
    ("unsorted", {}, True),
    ("unsorted", {"require_sorted": False}, False),
    ("duplicates", {}, False),
    ("duplicates", {"allow_duplicates": False}, True),
])
def test_validate_csr_matches_jax(kind, kw, bad):
    triple = _broken(kind)
    p, j = _raw_port(*triple), _raw_jax(*triple)
    if bad:
        with pytest.raises(IncorrectDimensions) as pe:
            pval.validate_csr(p, **kw)
        with pytest.raises(J.IncorrectDimensions) as je:
            jval.validate_csr(j, **kw)
        assert str(pe.value) == str(je.value)
    else:
        pval.validate_csr(p, **kw)
        jval.validate_csr(j, **kw)


def test_validate_csr_accepts_every_constructor():
    for a in (P.CSR.from_dense(_sparse(1, 9, 14)), P.CSR.eye((5, 5)),
              P.CSR.empty((3, 4)), P.CSR.create_diagonal([1, 0, 2]),
              P.CSR.from_dense(_sparse(2, 6, 6)) + P.CSR.eye((6, 6))):
        pval.validate_csr(a)
    pval.validate_csr(P.CSR.from_dense(_sparse(3, 5, 5)),
                      allow_duplicates=False)


def test_check_finite_and_spd_result_match_jax():
    good = np.asarray([[2.0, 0], [1.0, 3.0]], np.float32)
    pval.check_finite(torch.ones(3))
    pval.check_finite(np.ones(3))
    pval.check_finite(P.CSR.from_dense(good))
    assert pval.check_spd_result(P.CSR.from_dense(good)).stored == 3
    assert issubclass(pval.NumericalError, MatErr)
    assert pval.NumericalError.__name__ == jval.NumericalError.__name__
    for bad in (np.asarray([1.0, np.nan, np.inf], np.float32),):
        for arg in (torch.from_numpy(bad), bad):
            with pytest.raises(pval.NumericalError) as pe:
                pval.check_finite(arg, "thing")
        with pytest.raises(jval.NumericalError) as je:
            jval.check_finite(bad, "thing")
        assert str(pe.value) == str(je.value)
    nan_l = good.copy()
    nan_l[1, 1] = np.nan
    neg_l = good.copy()
    neg_l[0, 0] = -2.0
    nodiag = np.asarray([[2.0, 0], [1.0, 0.0]], np.float32)
    for d in (nan_l, neg_l, nodiag):
        with pytest.raises(pval.NumericalError) as pe:
            pval.check_spd_result(P.CSR.from_dense(d))
        with pytest.raises(jval.NumericalError) as je:
            jval.check_spd_result(J.CSR.from_dense(d))
        assert str(pe.value) == str(je.value)


def test_cholesky_of_a_non_spd_matrix_is_caught():
    a = P.CSR.from_dense(np.asarray([[1.0, 2.0], [2.0, 1.0]], np.float32))
    with pytest.raises(pval.NumericalError):
        pval.check_spd_result(P.cholesky(a))


def test_checkified_reports_non_finite_results():
    def f(x):
        return torch.log(x), {"n": 3}

    err, out = pval.checkified(f)(torch.tensor([1.0, 2.0]))
    assert err.get() is None
    err.throw()
    assert torch.allclose(out[0], torch.log(torch.tensor([1.0, 2.0])))
    err, out = pval.checkified(f)(torch.tensor([1.0, -2.0]))
    assert "non-finite" in err.get() and out[1] == {"n": 3}
    with pytest.raises(pval.NumericalError):
        err.throw()
    err, _ = pval.checkified(lambda: torch.tensor([1, 2]))()  # integers
    assert err.get() is None


# ---- Matrix Market ------------------------------------------------------------
@pytest.mark.parametrize("name", ["beam_stiffness_100.mtx", "frame3d_14.mtx",
                                  "plate2d_48.mtx"])
def test_read_fixture_matches_jax(name):
    path = os.path.join(DATA, name)
    _same_csr(pio.read_matrix_market(path), jio.read_matrix_market(path))


@pytest.mark.parametrize("suffix", [".mtx", ".mtx.gz"])
def test_files_written_by_one_package_read_in_the_other(tmp_path, suffix):
    d = _sparse(4, 23, 17)
    pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    pp, jp = str(tmp_path / ("p" + suffix)), str(tmp_path / ("j" + suffix))
    pio.write_matrix_market(pp, pa, comment="two\nlines")
    jio.write_matrix_market(jp, ja, comment="two\nlines")
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(pp, "rb") as f, opener(jp, "rb") as g:
        assert f.read() == g.read()             # byte for byte
    _same_csr(pio.read_matrix_market(jp), ja)   # JAX wrote, port reads
    back = jio.read_matrix_market(pp)           # port wrote, JAX reads
    _same_csr(pa, back)
    _same_csr(pio.read_matrix_market(pp), ja)


def test_symmetric_pattern_and_bad_headers(tmp_path):
    path = str(tmp_path / "s.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern symmetric\n"
                "% comment\n3 3 3\n1 1\n2 1\n3 2\n")
    p, j = pio.read_matrix_market(path), jio.read_matrix_market(path)
    _same_csr(p, j)
    assert np.array_equal(p.todense().numpy(),
                          [[1, 1, 0], [1, 0, 1], [0, 1, 0]])
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real skew-symmetric\n"
                "2 2 1\n2 1 3.5\n")
    _same_csr(pio.read_matrix_market(path), jio.read_matrix_market(path))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n1 1\n1.0\n")
    with pytest.raises(ValueError):
        pio.read_matrix_market(path)


@pytest.mark.parametrize("n,bandwidth,seed", [(100, 8, 0), (37, 3, 5),
                                              (10, 0, 1)])
def test_bcsstk_like_matches_jax(n, bandwidth, seed):
    p = pio.bcsstk_like(n, bandwidth, seed)
    _same_csr(p, jio.bcsstk_like(n, bandwidth, seed))
    d = p.todense().numpy()
    assert np.array_equal(d, d.T) and np.linalg.eigvalsh(d).min() > 0


# ---- checkpoints ----------------------------------------------------------------
def test_csr_checkpoints_cross_packages(tmp_path):
    d = _sparse(5, 20, 30)
    pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    pp, jp = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    pck.save_csr(pp, pa)
    jck.save_csr(jp, ja)
    with np.load(pp) as zp, np.load(jp) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert np.array_equal(zp[k], zj[k])
    _same_csr(pck.load_csr(jp), ja)
    _same_csr(pa, jck.load_csr(pp))
    out = pck.load_csr(pp)
    _same_csr(out, ja)
    pval.validate_csr(out, allow_duplicates=False)


def _banded_spd(n=60, bandwidth=5, seed=3):
    return pio.bcsstk_like(n, bandwidth, seed), \
        jio.bcsstk_like(n, bandwidth, seed)


@pytest.fixture
def banded_config(request):
    """``banded_solver`` set in both packages, natural order so the banded
    tier is taken at a small block."""
    backend = request.param
    jprev, pprev = jcfg.get_config(), pcfg.get_config()
    jcfg.set_config(dataclasses.replace(jprev, banded_solver=backend,
                                        ordering="natural"))
    pcfg.set_config(dataclasses.replace(pprev, banded_solver=backend,
                                        ordering="natural"))
    yield backend
    jcfg.set_config(jprev)
    pcfg.set_config(pprev)


@pytest.mark.parametrize("backend", ["scan", "bcr"])
def test_banded_checkpoints_cross_packages(tmp_path, backend):
    from basic_sparse_matrix_tpu.models import banded as jbd
    from basic_sparse_matrix_tpu.models import bcr as jbcr
    from basic_sparse_matrix_tpu_torch.models import banded as pbd
    from basic_sparse_matrix_tpu_torch.models import bcr as pbcr

    pa, ja = _banded_spd()
    b = np.random.default_rng(6).standard_normal((60, 3)).astype(np.float32)
    if backend == "scan":
        jfac, pfac = jbd.factor_banded(ja, 8), pbd.factor_banded(pa, 8)
        jsolve = lambda f: jbd.solve_factored_banded(f, b)      # noqa: E731
        psolve = lambda f: pbd.solve_factored_banded(           # noqa: E731
            f, torch.from_numpy(b)).numpy()
    else:
        jfac, pfac = jbcr.prepare_bcr(ja, 8), pbcr.prepare_bcr(pa, 8)
        jsolve = lambda f: f.solve(b)                           # noqa: E731
        psolve = lambda f: f.solve(torch.from_numpy(b)).numpy()  # noqa: E731
    ref = np.asarray(jsolve(jfac))
    jp, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jck.save_banded(jp, jfac)
    pck.save_banded(pp, pfac)
    with np.load(pp) as zp, np.load(jp) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert str(zp["kind"]) == str(zj["kind"])
    loaded = pck.load_banded(jp)                # JAX wrote, port loads
    assert type(loaded) is type(pfac)
    _close(psolve(loaded), ref)
    _close(psolve(pck.load_banded(pp)), ref)
    _close(jsolve(jck.load_banded(pp)), ref)    # port wrote, JAX loads
    if backend == "scan":
        _close(loaded.L.numpy(), np.asarray(jfac.L))


@pytest.mark.parametrize("banded_config", ["scan", "bcr"], indirect=True)
def test_direct_checkpoints_cross_packages(tmp_path, banded_config):
    pa, ja = _banded_spd(n=80, bandwidth=6, seed=7)
    b = np.random.default_rng(8).standard_normal((80, 2)).astype(np.float32)
    jsolver, psolver = J.prepare_direct(ja), P.prepare_direct(pa)
    kind = {"scan": "banded", "bcr": "banded-bcr"}[banded_config]
    assert jsolver.kind == psolver.kind == kind
    ref = np.asarray(jsolver.solve(b))
    jp, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jck.save_direct(jp, jsolver)
    pck.save_direct(pp, psolver)
    with np.load(pp) as zp, np.load(jp) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert str(zp["kind"]) == str(zj["kind"])
    for path in (jp, pp):
        loaded = pck.load_direct(path)
        assert loaded.kind == kind and loaded.n == 80
        _close(loaded.solve(torch.from_numpy(b)).numpy(), ref)
        _close(loaded.solve(torch.from_numpy(b[:, 0])).numpy(), ref[:, 0])
    _close(jck.load_direct(pp).solve(b), ref)
    x64 = np.linalg.solve(pa.todense().numpy().astype(np.float64), b)
    _close(pck.load_direct(jp).solve(torch.from_numpy(b)).numpy(), x64)


def test_direct_checkpoint_keeps_the_permutation(tmp_path):
    """Under RCM the factor lives in permuted space: the loaded solver must
    carry ``perm`` (solving without it answers another system)."""
    prev = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(prev, ordering="rcm",
                                        banded_solver="scan"))
    try:
        rng = np.random.default_rng(9)
        perm = rng.permutation(50)
        a0, _ = _banded_spd(n=50, bandwidth=4, seed=10)
        d = a0.todense().numpy()[np.ix_(perm, perm)]
        a = P.CSR.from_dense(d)
        solver = P.prepare_direct(a)
        assert solver.perm is not None and solver.kind == "banded"
        path = str(tmp_path / "d.npz")
        pck.save_direct(path, solver)
        loaded = pck.load_direct(path)
        assert np.array_equal(loaded.perm, solver.perm)
        b = torch.from_numpy(rng.standard_normal(50).astype(np.float32))
        assert torch.equal(loaded.solve(b), solver.solve(b))
        _close(loaded.solve(b).numpy(),
               np.linalg.solve(d.astype(np.float64), b.numpy()))
    finally:
        pcfg.set_config(prev)


def test_save_direct_refuses_the_other_tiers(tmp_path):
    prev = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(prev, banded_max_block=0,
                                        ordering="natural"))
    try:
        a, _ = _banded_spd(n=40, bandwidth=3, seed=11)
        solver = P.prepare_direct(a)
        assert solver.kind in ("supernodal", "scatter")
        with pytest.raises(ValueError):
            pck.save_direct(str(tmp_path / "x.npz"), solver)
    finally:
        pcfg.set_config(prev)


def _tridiag(n=24):
    return (4.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
            ).astype(np.float32)


def test_factor_state_roundtrip_crosses_packages(tmp_path):
    p = str(tmp_path / "f.npz")
    pck.save_factor_state(p, torch.arange(5, dtype=torch.float32), 3,
                          meta={"tag": 7})
    for load in (pck.load_factor_state, jck.load_factor_state):
        lv, done = load(p)
        assert done == 3 and lv.tolist() == [0, 1, 2, 3, 4]
    jck.save_factor_state(p, np.arange(4, dtype=np.float32), 2)
    lv, done = pck.load_factor_state(p)
    assert done == 2 and lv.tolist() == [0, 1, 2, 3]


def test_checkpointed_factorize_interrupted_and_resumed_is_exact(
        tmp_path, monkeypatch):
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc

    a = P.CSR.from_dense(_tridiag(24))
    sched = sc.analyze(a)
    assert sched.n_levels == 24
    direct = sc.factorize(sched, a.values)
    path = str(tmp_path / "ck.npz")
    whole = pck.checkpointed_factorize(sched, a.values, path, every=5)
    assert np.array_equal(whole, direct.numpy())
    assert os.path.exists(path)
    assert pck.load_factor_state(path)[1] == 20   # last snapshot mid-run
    os.remove(path)

    # interrupt after the second snapshot (levels 0..9 applied and saved)
    saves = []
    save = pck.save_factor_state

    def interrupting(p, lvals, level_done, meta=None):
        save(p, lvals, level_done, meta)
        saves.append(level_done)
        if len(saves) == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(pck, "save_factor_state", interrupting)
    with pytest.raises(KeyboardInterrupt):
        pck.checkpointed_factorize(sched, a.values, path, every=5)
    assert saves == [5, 10] and pck.load_factor_state(path)[1] == 10
    monkeypatch.setattr(pck, "save_factor_state", save)

    # the resumed run applies only levels 10.. and equals the whole run
    seen = []
    levels = sc.factor_levels
    monkeypatch.setattr(sc, "factor_levels",
                        lambda s, lv, lo, hi: seen.append((lo, hi))
                        or levels(s, lv, lo, hi))
    resumed = pck.checkpointed_factorize(sched, a.values, path, every=5)
    assert seen == [(10, 15), (15, 20), (20, 24)]
    assert np.array_equal(resumed, direct.numpy())


def test_factor_state_written_by_jax_resumes_in_the_port(tmp_path):
    """For the full factor the port's pattern levels equal the JAX
    package's etree levels, so a JAX state file (values in the same CSC
    order, scratch slot last) resumes under the port's schedule."""
    from basic_sparse_matrix_tpu.models import sparse_cholesky as jsc
    from basic_sparse_matrix_tpu_torch.models import sparse_cholesky as sc

    d = _tridiag(24)
    pa, ja = P.CSR.from_dense(d), J.CSR.from_dense(d)
    jsched = jsc.analyze(ja)
    path = str(tmp_path / "ck.npz")
    jref = jck.checkpointed_factorize(jsched, np.asarray(ja.values), path,
                                      every=7)
    lv, done = pck.load_factor_state(path)
    sched = sc.analyze(pa)
    assert done == 21 and lv.shape[0] == sched.nnz_l + 1
    resumed = pck.checkpointed_factorize(sched, pa.values, path, every=7)
    np.testing.assert_allclose(resumed, jref, rtol=1e-5)
    np.testing.assert_allclose(resumed,
                               sc.factorize(sched, pa.values).numpy(),
                               rtol=1e-6)
    # and the carried CSR bridges to the same matrix
    bridged = interop.csr_from_numpy(*ja.numpy(), ja.shape)
    assert bridged.allclose(pa)


# ---- profiling ------------------------------------------------------------------
def test_profiling_on_the_cpu_spec():
    chip = prof.detect_chip("cpu")
    assert chip is prof.CPU and chip.name == "cpu" and chip.hbm_bw > 0
    if not torch.cuda.is_available():
        assert prof.detect_chip() is prof.CPU
    assert prof.H100.hbm_bw == 3.35e12 and prof.H100.mxu_f32 == 67e12
    assert prof.H100.tf32 == 495e12 and prof.H100.mxu_bf16 == 989e12
    assert not any("v5e" in n.lower() for n in dir(prof))
    with prof.recording():
        with prof.timed("unit_op", flops=100.0, bytes_moved=50.0, nnz=10,
                        device="cpu") as m:
            torch.ones(10).sum()
    assert m.seconds > 0 and m.nnz_per_s > 0 and m.gflops_per_s > 0
    # timed records through the recorder: a span carrying the metrics
    (s,) = prof.snapshot().spans
    assert s.name == "bsm.unit_op" and s.attrs["nnz"] == 10
    assert s.attrs["seconds"] == m.seconds and s.attrs["flops"] == 100.0
    assert 0 <= m.roofline_fraction(prof.CPU) < 1e12
    om = prof.OpMetrics(op="x", seconds=0.5, flops=1e9, bytes_moved=1e6,
                        nnz=500)
    # bound: max(1e6 / 3.35e12, 1e9 / 67e12) = 1.49e-5 s of 0.5 s
    assert om.roofline_fraction(prof.H100) == pytest.approx(
        (1e9 / 67e12) / 0.5)
    js = om.to_json()
    assert '"op": "x"' in js and "gflops_per_s" in js
    with prof.span("bsm.named-range"):
        pass


def test_spmm_cost_matches_jax():
    from basic_sparse_matrix_tpu.runtime.profiling import spmm_cost as jcost

    for args in (dict(nnz=1000, n_rhs=64, rows=100, cols=100),
                 dict(nnz=10, n_rhs=8, rows=5, cols=500, dtype_bytes=2)):
        assert prof.spmm_cost(**args) == jcost(**args)
    c = prof.spmm_cost(nnz=1000, n_rhs=64, rows=100, cols=100)
    assert c["flops"] == 2 * 1000 * 64
