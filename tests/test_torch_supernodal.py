"""Supernodal Cholesky of the PyTorch port against the JAX package on the CPU.

* ``analyze_supernodal``: the routing tuples (``use_vmem``, ``use_pallas``,
  ``use_delta``, ``use_window``, ``kread``, ``vmem_shape``, the per-group
  row counts) and every host table, exactly (dtypes included: the port
  keeps the ``uint16`` row tables on the host and widens them to int32 on
  the device).
* ``factorize_supernodal`` under every ``supernodal_gather`` ×
  ``supernodal_scatter`` mode on a 2-D (16², n = 256) and a 3-D (8³,
  n = 512) Laplacian in nested-dissection order, against the JAX factor
  under its defaults (Pallas in interpret mode, computed once per matrix):
  ``rtol=1e-5``, ``atol=1e-6·max|ref|`` (float32 products summed in
  another order). Each mode must reach the kernel wrappers it routes to.
* ``cholesky_supernodal`` against a float64 dense Cholesky on the JAX
  package's own cases, ``rtol=1e-4``, ``atol=1e-5`` (its tests' bound).
"""

import dataclasses

import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import supernodal as jsn
from basic_sparse_matrix_tpu.ops import reorder as jr
from basic_sparse_matrix_tpu.utils import config as jcfg
from basic_sparse_matrix_tpu_torch.models import supernodal as psn
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield

RTOL = 1e-5
ATOL_OF_MAX = 1e-6
GATHERS = ("auto", "element", "window", "kernel")
SCATTERS = ("auto", "element", "delta", "pallas", "vmem")


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


def _ordered_pair(k, dim, ordering):
    n, r, c, v = _lap(k, dim)
    ja = J.CSR.from_coo_arrays((n, n), r, c, v)
    pa = P.CSR.from_coo_arrays((n, n), r, c, v)
    if ordering == "natural":
        return ja, pa
    jperm = getattr(jr, f"{ordering}_permutation")(ja)
    pperm = getattr(pr, f"{ordering}_permutation")(pa)
    assert np.array_equal(jperm, pperm)
    return (jr.permute_symmetric(ja, jperm), pr.permute_symmetric(pa, pperm))


_ROUTING = ("use_vmem", "use_pallas", "use_delta", "use_window", "kread",
            "vmem_shape", "panel_rmax", "delta_rmax", "nnz_l", "n")


@pytest.mark.parametrize("k,dim,ordering", [
    (16, 2, "nd"), (12, 2, "rcm"), (8, 3, "nd"), (7, 3, "natural"),
    (10, 3, "nd"),
])
@pytest.mark.parametrize("relax", [0, 8])
def test_analyze_matches_jax(k, dim, ordering, relax):
    ja, pa = _ordered_pair(k, dim, ordering)
    js = jsn.analyze_supernodal(ja, relax=relax)
    ps = psn.analyze_supernodal(pa, relax=relax)
    for name in _ROUTING:
        assert getattr(ps, name) == getattr(js, name), name
    assert ps.n_groups == js.n_groups
    assert ps.avg_panel_width == js.avg_panel_width
    for name in psn._TABLE_NAMES:
        for gi, (pt, jt) in enumerate(zip(getattr(ps, name),
                                          getattr(js, name))):
            assert pt.dtype == jt.dtype, (name, gi)
            assert np.array_equal(pt, jt), (name, gi)
            dev = ps.tabs[gi][psn._TABLE_INDEX[name]]
            assert np.array_equal(dev.numpy(), jt), (name, gi)
            assert dev.dtype == (torch.bool if jt.dtype == bool
                                 else torch.int32)
    assert np.array_equal(ps.a_src_pos.numpy(), np.asarray(js.a_src_pos))
    assert np.array_equal(ps.a_vals_idx.numpy(), np.asarray(js.a_vals_idx))
    for p_, j_ in zip(ps.l_pattern, js.l_pattern):
        assert np.array_equal(p_, j_)


_FACTOR_CASES = {"lap2d_16": (16, 2), "lap3d_8": (8, 3)}


@pytest.fixture(scope="module")
def jax_factors():
    """The JAX package's factor of each case under its default modes (the
    runs_read / addback_resident kernels in interpret mode), once."""
    out = {}
    for name, (k, dim) in _FACTOR_CASES.items():
        ja, pa = _ordered_pair(k, dim, "nd")
        js = jsn.analyze_supernodal(ja, relax=8)
        out[name] = (np.asarray(jsn.factorize_supernodal(js, ja.values)), pa)
    return out


@pytest.fixture
def port_config():
    old = pcfg.get_config()
    yield lambda **kw: pcfg.set_config(dataclasses.replace(old, **kw))
    pcfg.set_config(old)


def _counting(monkeypatch):
    """Count the calls that reach each kernel wrapper (on the CPU they run
    the plain versions and launch nothing)."""
    calls = {"runs_read": 0, "addback_rects": 0, "addback_resident": 0,
             "panel_addback": 0}
    for mod, name in ((k3, "runs_read"), (k4, "addback_rects"),
                      (k4, "addback_resident"), (k5, "panel_addback")):
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("case", list(_FACTOR_CASES))
@pytest.mark.parametrize("scatter", SCATTERS)
@pytest.mark.parametrize("gather", GATHERS)
def test_factorize_matches_jax(jax_factors, port_config, monkeypatch, case,
                               gather, scatter):
    want, pa = jax_factors[case]
    port_config(supernodal_gather=gather, supernodal_scatter=scatter)
    sched = psn.analyze_supernodal(pa, relax=8)
    calls = _counting(monkeypatch)
    got = psn.factorize_supernodal(sched, pa.values)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL_OF_MAX * np.abs(want).max())
    levels = sum(int(sched.tabs[gi][0].shape[0])
                 for gi in range(sched.n_groups)
                 if psn._group_delta(sched, gi, scatter) == "rects")
    assert bool(calls["runs_read"]) == (gather in ("auto", "kernel"))
    assert calls["addback_rects"] == levels
    assert calls["addback_resident"] == calls["panel_addback"] == 0
    if scatter in ("vmem", "pallas"):
        assert levels > 0


def test_groups_per_program_changes_nothing(jax_factors, port_config):
    want, pa = jax_factors["lap3d_8"]
    sched = psn.analyze_supernodal(pa, relax=8)
    base = psn.factorize_supernodal(sched, pa.values)
    port_config(supernodal_groups_per_program=2)
    assert torch.equal(psn.factorize_supernodal(sched, pa.values), base)


def _dense_cases():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((12, 12))
    arrow = np.eye(8, dtype=np.float32) * 5
    arrow[7, :] = 1
    arrow[:, 7] = 1
    arrow[7, 7] = 20
    band = (4 * np.eye(30) - np.eye(30, k=1) - np.eye(30, k=-1)
            - 0.5 * np.eye(30, k=3) - 0.5 * np.eye(30, k=-3))
    n, r, c, v = _lap(6, 2)
    lap = np.zeros((n, n), np.float32)
    lap[r, c] = v
    return {
        "dense": (m @ m.T + 12 * np.eye(12)).astype(np.float32),
        "tridiag": (4 * np.eye(20) - np.eye(20, k=1)
                    - np.eye(20, k=-1)).astype(np.float32),
        "lap2d": lap,
        "arrow": arrow,
        "banded": band.astype(np.float32),
        "reference0": np.asarray(
            [[4.0, 12, -16], [12, 37, -43], [-16, -43, 98]],
            dtype=np.float32),
    }


@pytest.mark.parametrize("name", list(_dense_cases()))
def test_cholesky_supernodal_matches_dense_oracle(name):
    a = _dense_cases()[name]
    l = psn.cholesky_supernodal(P.CSR.from_dense(a))
    ref = np.linalg.cholesky(a.astype(np.float64))
    np.testing.assert_allclose(l.todense().numpy(), ref, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("a,same_values", [
    ([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 3.0]], True),
    ([[1.0, 2.0, 1.0, 0], [2.0, 1.0, 1.0, 0], [1.0, 1.0, 5.0, 1],
      [0, 0, 1, 4]], True),
    # A NaN from an earlier failed panel reaches the next panel: the JAX
    # CPU Cholesky lets it propagate from its pivot on, the port marks the
    # whole panel failed (zeros after the isfinite guard) — same NaN
    # positions, other finite values.
    ([[-1.0, 0, 1], [0, 2.0, 1], [1, 1, 6.0]], False),
])
def test_not_positive_definite_gives_nan_like_jax(a, same_values):
    """A matrix that is not positive definite factors without raising, to
    NaN where the JAX package's factor has NaN (its ``cholesky`` returns
    NaN for a failed panel; the port's failed panels are set to NaN)."""
    a = np.asarray(a, np.float32)
    old = jcfg.get_config()
    jcfg.set_config(dataclasses.replace(old, supernodal_gather="element",
                                        supernodal_scatter="element"))
    try:
        want = np.asarray(jsn.cholesky_supernodal(
            J.CSR.from_dense(a)).todense())
    finally:
        jcfg.set_config(old)
    got = psn.cholesky_supernodal(P.CSR.from_dense(a)).todense().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if same_values:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   equal_nan=True)


def test_narrow_tables_widen_on_upload():
    """n <= 65535: uint16 host tables (as in the JAX package), int32 device
    tables; n > 65535: int32 in both."""
    _, pa = _ordered_pair(6, 2, "nd")
    s = psn.analyze_supernodal(pa)
    ti = psn._TABLE_INDEX["upd_irows"]
    assert all(t.dtype == np.uint16 for t in s.upd_irows)
    assert all(t[ti].dtype == torch.int32 for t in s.tabs)
    blocks, bs = 8193, 8           # n = 65544 > 0xFFFF, one level deep
    n = blocks * bs
    rr, cc = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    offs = (np.arange(blocks) * bs)[:, None, None]
    spd = (np.ones((bs, bs)) + bs * np.eye(bs)).astype(np.float32)
    a = P.CSR.from_coo_arrays(
        (n, n), (rr[None] + offs).ravel(), (cc[None] + offs).ravel(),
        np.broadcast_to(spd, (blocks, bs, bs)).ravel())
    s = psn.analyze_supernodal(a)
    assert all(t.dtype == np.int32 for t in s.upd_irows)
    lv = psn.factorize_supernodal(s, a.values)
    l = psn.assemble_factor(a, lv, s)
    ref = np.linalg.cholesky(spd.astype(np.float64))
    indptr, indices, values = l.numpy()
    o = 4096 * bs
    blk = np.zeros((bs, bs))
    for i in range(bs):
        lo, hi = indptr[o + i], indptr[o + i + 1]
        blk[i, indices[lo:hi] - o] = values[lo:hi]
    np.testing.assert_allclose(blk, ref, rtol=1e-4, atol=1e-5)
