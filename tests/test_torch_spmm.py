"""SpMM/SpMV parity of the PyTorch port against the JAX package on the CPU:
``spmm``, ``spmv``, ``mul_dense``, ``mul_vector``, ``spmm_to_csr``, the ELL
path, the dense, ELL and segment rungs of ``spmm_auto``, the integer-dtype
cases (exact, as the JAX tests pin them), config and timing.

Float32 results match to ``rtol=1e-5`` (both sum in float32 on the CPU,
in an order of the same class); integer results are ``array_equal``.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.ops import ell as je
from basic_sparse_matrix_tpu_torch.ops import ell as pe
from basic_sparse_matrix_tpu_torch.utils import config as pc

# ``ops.spmm`` is rebound to the function by both packages' ops/__init__.
jm = importlib.import_module("basic_sparse_matrix_tpu.ops.spmm")
pm = importlib.import_module("basic_sparse_matrix_tpu_torch.ops.spmm")

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield

RTOL, ATOL = 1e-5, 1e-5


def _dense(seed, rows, cols, density):
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, cols)) < density)
            * rng.standard_normal((rows, cols))).astype(np.float32)


def _rhs(seed, rows, n):
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(
        np.float32)


def _close(p, j):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


SHAPES = [(50, 70, 0.1, 9), (33, 20, 0.3, 1), (256, 256, 0.001, 8),
          (64, 64, 0.0, 5), (1, 300, 0.5, 3)]


@pytest.mark.parametrize("rows,cols,density,n", SHAPES)
def test_spmm_and_spmv_match_jax(rows, cols, density, n):
    d, b = _dense(1, rows, cols, density), _rhs(2, cols, n)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    _close(pm.spmm(p, torch.from_numpy(b)), jm.spmm(j, jnp.asarray(b)))
    _close(pm.spmv(p, torch.from_numpy(b[:, 0])),
           jm.spmv(j, jnp.asarray(b[:, 0])))


@pytest.mark.parametrize("rows,cols,density,n", SHAPES)
def test_mul_dense_and_mul_vector_match_jax(rows, cols, density, n):
    d, b = _dense(3, rows, cols, density), _rhs(4, cols, n)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    _close(P.mul_dense(p, b), J.mul_dense(j, b))
    _close(P.mul_vector(p, b[:, 0]), J.mul_vector(j, b[:, 0]))


def test_dimension_errors_match_jax():
    p, j = P.CSR.eye((4, 4)), J.CSR.eye((4, 4))
    for pkg, a in ((P, p), (J, j)):
        with pytest.raises(pkg.IncorrectDimensions):
            pkg.mul_dense(a, np.ones((3, 2), np.float32))
        with pytest.raises(pkg.IncorrectDimensions):
            pkg.mul_dense(a, np.ones(4, np.float32))
        with pytest.raises(pkg.IncorrectDimensions):
            pkg.mul_vector(a, np.ones(5, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_to_csr_matches_jax(seed):
    d = _dense(seed, 30, 20, 0.2)
    b = _rhs(seed + 10, 20, 6)
    b[:, 2] = 0.0  # a zero column: its products are exact zeros, dropped
    p = pm.spmm_to_csr(P.CSR.from_dense(d), b)
    j = jm.spmm_to_csr(J.CSR.from_dense(d), b)
    assert np.array_equal(p.indptr.numpy(), np.asarray(j.indptr))
    assert np.array_equal(p.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_allclose(p.values.numpy(), np.asarray(j.values),
                               rtol=RTOL, atol=ATOL)


def _one_per_row(seed, n):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    d[np.arange(n), rng.integers(0, n, n)] = rng.standard_normal(n)
    return d


@pytest.mark.parametrize("density,rung", [(0.5, "dense"), (0.02, "dense"),
                                          (None, "ell"), (0.001, "segment"),
                                          (0.0, "segment")])
def test_spmm_auto_takes_the_jax_rung(density, rung):
    # None: one entry per row, density 1/256 under the dense threshold and
    # ELL overhead 1; 0.001: rows of 0-3 entries, ELL overhead above 4.
    d = _one_per_row(5, 256) if density is None else _dense(5, 256, 256,
                                                            density)
    b = _rhs(6, 256, 8)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    _close(pm.spmm_auto(p, torch.from_numpy(b)),
           jm.spmm_auto(j, jnp.asarray(b)))
    taken = ("dense" if p._dense_cache is not None
             else "ell" if p._ell_cache is not None else "segment")
    assert taken == rung
    assert (p._dense_cache is not None) == hasattr(j, "_dense_cache")
    assert (p._ell_cache is not None) == hasattr(j, "_ell_cache")


def test_spmm_auto_segment_rung_for_skewed_rows():
    d = np.zeros((200, 300), np.float32)
    d[0, :] = 1.0               # one full row: ELL overhead far above 4
    d[1:, 0] = 2.0
    b = _rhs(7, 300, 4)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    cfg = pc.get_config()
    pc.set_config(dataclasses.replace(cfg, dense_dispatch_density=1.0))
    from basic_sparse_matrix_tpu.utils import config as jc

    jcfg = jc.get_config()
    jc.set_config(dataclasses.replace(jcfg, dense_dispatch_density=1.0))
    try:
        _close(pm.spmm_auto(p, torch.from_numpy(b)),
               jm.spmm_auto(j, jnp.asarray(b)))
    finally:
        pc.set_config(cfg)
        jc.set_config(jcfg)
    assert p._ell_cache is None and p._dense_cache is None


def test_ell_layout_and_products_match_jax():
    d = _dense(8, 50, 70, 0.1)
    b = _rhs(9, 70, 9)
    pell, jell = pe.csr_to_ell(P.CSR.from_dense(d)), \
        je.csr_to_ell(J.CSR.from_dense(d))
    assert np.array_equal(pell.cols.numpy(), np.asarray(jell.cols))
    assert np.array_equal(pell.vals.numpy(), np.asarray(jell.vals))
    assert np.array_equal(pell._host_cols, jell._host_cols)
    _close(pe.spmm_ell(pell, torch.from_numpy(b)),
           je.spmm_ell(jell, jnp.asarray(b)))
    _close(pe.spmv_ell(pell, torch.from_numpy(b[:, 0])),
           je.spmv_ell(jell, jnp.asarray(b[:, 0])))
    a = P.CSR.from_dense(d)
    assert pe.ell_overhead(a) == je.ell_overhead(J.CSR.from_dense(d))


def test_spmm_ell_row_chunks_agree(monkeypatch):
    d = _dense(10, 97, 40, 0.2)
    b = _rhs(11, 40, 6)
    ell = pe.csr_to_ell(P.CSR.from_dense(d))
    whole = pe.spmm_ell(ell, torch.from_numpy(b))
    monkeypatch.setattr(pe, "INTERMEDIATE_BUDGET_BYTES",
                        10 * ell.width * 6 * 4)  # ten rows a chunk
    assert pe._chunk_rows(ell, 6) == 10
    np.testing.assert_allclose(pe.spmm_ell(ell, torch.from_numpy(b)).numpy(),
                               whole.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(whole.numpy(), d @ b, rtol=1e-4, atol=1e-5)


def test_cpu_never_takes_the_stream_kernel():
    from basic_sparse_matrix_tpu_torch.ops.pallas import stream_kernel as sk

    rows = 20000
    rng = np.random.default_rng(12)
    a = P.CSR.from_coo_arrays(
        (rows, rows), np.repeat(np.arange(rows), 14),
        rng.integers(0, rows, rows * 14),
        rng.standard_normal(rows * 14).astype(np.float32))
    assert a.stored >= 1 << 18
    b = torch.zeros((rows, 128))
    before = sk.LAUNCHES
    pe.spmm_ell_from_csr(a, b)
    assert sk.LAUNCHES == before and not a._ell_cache._stream_plans


# ---- integer dtypes (tests/test_integer_dtypes.py:66-126) ---------------- #
def _int_coo(seed, n, nnz, dtype, lo=0, hi=255):
    rng = np.random.default_rng(seed)
    return (n, rng.integers(0, n, nnz), rng.integers(0, n, nnz),
            rng.integers(lo, hi, nnz).astype(dtype))


def _dense_of(n, rows, cols, vals):
    d = np.zeros((n, n), dtype=vals.dtype)
    np.add.at(d, (rows, cols), vals)
    return d


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_spmm_integer_exact(dtype):
    n, ra, ca, va = _int_coo(5, 40, 200, dtype)
    bd = np.random.default_rng(6).integers(0, 16, (n, 8)).astype(dtype)
    p = pm.spmm(P.CSR.from_coo_arrays((n, n), ra, ca, va),
                torch.from_numpy(bd))
    j = jm.spmm(J.CSR.from_coo_arrays((n, n), ra, ca, va), jnp.asarray(bd))
    assert p.numpy().dtype == np.asarray(j).dtype == dtype
    assert np.array_equal(p.numpy(), np.asarray(j))
    ref = _dense_of(n, ra, ca, va).astype(np.int64) @ bd.astype(np.int64)
    assert np.array_equal(p.numpy().astype(np.int64), ref)


def test_spmv_integer_exact():
    n, ra, ca, va = _int_coo(7, 40, 200, np.int32, 0, 10)
    v = np.arange(n, dtype=np.int32)
    p = P.mul_vector(P.CSR.from_coo_arrays((n, n), ra, ca, va), v)
    j = J.mul_vector(J.CSR.from_coo_arrays((n, n), ra, ca, va), v)
    assert np.array_equal(p.numpy(), np.asarray(j))
    assert np.array_equal(p.numpy().astype(np.int64),
                          _dense_of(n, ra, ca, va).astype(np.int64) @ v)


def test_u32_reference_bench_recipe_exact():
    n, inserts = 1000, 20_000
    rng = np.random.default_rng(1000)
    rows = rng.integers(0, n, inserts)
    cols = rng.integers(0, n, inserts)
    vals = (rng.integers(0, 2**32, inserts) % 255).astype(np.uint32)
    bd = rng.integers(0, 4, (n, 10)).astype(np.uint32)
    p = pm.spmm(P.CSR.from_coo_arrays((n, n), rows, cols, vals),
                torch.from_numpy(bd))
    j = jm.spmm(J.CSR.from_coo_arrays((n, n), rows, cols, vals),
                jnp.asarray(bd))
    assert np.array_equal(p.numpy(), np.asarray(j))
    ref = _dense_of(n, rows, cols, vals).astype(np.uint64) @ bd.astype(
        np.uint64)
    assert np.array_equal(p.numpy().astype(np.uint64), ref)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("density_n", [(40, 200), (200, 60)])
def test_mul_dense_integer_matches_jax(dtype, density_n):
    # (40, 200) is dense enough for the dense rung (float32 result);
    # (200, 60) goes to the ELL rung (integer result).
    n, nnz = density_n
    _, ra, ca, va = _int_coo(13, n, nnz, dtype, 0, 9)
    bd = np.random.default_rng(14).integers(0, 9, (n, 5)).astype(dtype)
    p = P.mul_dense(P.CSR.from_coo_arrays((n, n), ra, ca, va), bd)
    j = J.mul_dense(J.CSR.from_coo_arrays((n, n), ra, ca, va), bd)
    assert p.numpy().dtype == np.asarray(j).dtype
    assert np.array_equal(p.numpy(), np.asarray(j))


def test_uint32_sums_wrap_like_jax():
    vals = np.array([2**32 - 1, 2], dtype=np.uint32)
    p = P.CSR.from_coo_arrays((1, 2), [0, 0], [0, 1], vals)
    j = J.CSR.from_coo_arrays((1, 2), [0, 0], [0, 1], vals)
    x = np.ones(2, np.uint32)
    assert np.array_equal(P.mul_vector(p, x).numpy(),
                          np.asarray(J.mul_vector(j, x)))


# ---- config and timing ---------------------------------------------------- #
def test_config_fields_cover_jax_and_env_overrides():
    from basic_sparse_matrix_tpu.utils.config import Config as JConfig

    jnames = {f.name for f in dataclasses.fields(JConfig)}
    pnames = {f.name for f in dataclasses.fields(pc.Config)}
    assert jnames <= pnames
    assert pnames - jnames == {"cuda_stream_tile_m", "cuda_stream_tile_k",
                               "device"}
    assert pc.Config().device == "cuda"
    for name in ("dense_dispatch_density", "dense_dispatch_max_bytes",
                 "bsr_min_fill", "ell_max_overhead", "ell_stream"):
        assert getattr(pc.Config(), name) == getattr(JConfig(), name)
    env = {**os.environ, "BSM_BSR_MIN_FILL": "0.5",
           "BSM_CUDA_STREAM_TILE_M": "32", "BSM_ELL_STREAM": "off"}
    out = subprocess.run(
        [sys.executable, "-c",
         "from basic_sparse_matrix_tpu_torch.utils.config import get_config;"
         "c = get_config();"
         "print(c.bsr_min_fill, c.cuda_stream_tile_m, c.ell_stream)"],
        env=env, capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["0.5", "32", "off"]


# ---- the default device ---------------------------------------------------- #
def test_default_device_explicit_argument_wins():
    assert pc.default_device("cpu") == torch.device("cpu")
    assert pc.default_device(torch.device("cuda", 1)) == torch.device("cuda:1")
    assert pc.default_device("meta").type == "meta"
    with pc.use_device("cuda"):
        # an explicit device is taken whatever the configuration says
        a = P.CSR.eye((3, 3), device="cpu")
        assert a.device.type == "cpu"
        assert P.Dense.from_data([[1.0, 2.0]], device="cpu").array.device \
            .type == "cpu"


def test_use_device_sets_and_restores_the_default():
    before = pc.get_config()
    with pc.use_device("cpu"):
        assert pc.get_config().device == "cpu"
        assert pc.default_device() == torch.device("cpu")
        assert P.CSR.eye((2, 2)).device.type == "cpu"
        assert P.Dense.new_default_with_dims(2, 3).array.device.type == "cpu"
    assert pc.get_config() is before


@pytest.mark.parametrize("build", [
    lambda: P.CSR.from_coo_arrays((2, 2), [0], [1], [1.0]),
    lambda: P.CSR.from_dense(np.eye(2, dtype=np.float32)),
    lambda: P.CSR.eye((2, 2)),
    lambda: P.CSR.create_diagonal([1.0, 2.0]),
    lambda: P.CSR.empty((2, 2)),
    lambda: P.Dense.from_data([[1.0, 2.0]]),
    lambda: P.Dense.new_default_with_dims(2, 2),
], ids=["from_coo_arrays", "from_dense", "eye", "create_diagonal", "empty",
        "Dense.from_data", "Dense.new_default_with_dims"])
def test_default_device_without_a_card_raises_the_named_error(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pc.use_device("cuda"):
        with pytest.raises(pc.NoDefaultDevice) as err:
            build()
    assert 'device="cpu"' in str(err.value)
    assert "BSM_DEVICE=cpu" in str(err.value)


def test_bsm_device_env_override_wins_in_a_subprocess():
    code = ("import basic_sparse_matrix_tpu_torch as P;"
            "from basic_sparse_matrix_tpu_torch.utils.config import "
            "get_config, default_device;"
            "print(get_config().device, default_device(), "
            "P.CSR.eye((3, 3)).device.type)")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "BSM_DEVICE": "cpu"},
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["cpu", "cpu", "cpu"]
    if torch.cuda.is_available():
        return
    # and without the override, on a machine with no card, the named error
    env = {k: v for k, v in os.environ.items() if k != "BSM_DEVICE"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode != 0 and "NoDefaultDevice" in out.stderr
    assert "BSM_DEVICE=cpu" in out.stderr


def test_matmul_precision_turns_tf32_off_and_restores():
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        with pc.matmul_precision():
            assert flags.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = prev


def test_cuda_timing_raises_without_a_device():
    from basic_sparse_matrix_tpu_torch.runtime import timing

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        timing.cuda_time_ms(lambda: None)
