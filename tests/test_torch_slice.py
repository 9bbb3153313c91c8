"""The ported CSR × dense SpMM slice as a whole, on the CPU at small size:
the same matrices (carried across with ``ops.interop``) and the same RHS go
through the JAX package's ``mul_dense`` and the port's, for every rung the
CPU reaches, to ``rtol=1e-5``. Also: the port and ``chip_smoke.py`` import
no JAX, and ``chip_smoke.py`` refuses to run without a CUDA device.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu_torch.ops import interop

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield

ROOT = Path(__file__).resolve().parent.parent


def _sd_mul(seed, n, inserts):
    """The reference sd_mul recipe at small size: random inserts with
    values 0..254, duplicates summed."""
    rng = np.random.default_rng(seed)
    return J.CSR.from_coo_arrays(
        (n, n), rng.integers(0, n, inserts), rng.integers(0, n, inserts),
        rng.integers(0, 255, inserts).astype(np.float32))


def _block_sparse(seed, n, bm, bk, frac):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    nb = (n // bm) * (n // bk)
    for t in rng.choice(nb, max(1, int(nb * frac)), replace=False):
        r, c = divmod(int(t), n // bk)
        d[r * bm:(r + 1) * bm, c * bk:(c + 1) * bk] = rng.standard_normal(
            (bm, bk))
    return J.CSR.from_dense(d)


def _uniform_rows(seed, n, per):
    rng = np.random.default_rng(seed)
    return J.CSR.from_coo_arrays(
        (n, n), np.repeat(np.arange(n), per), rng.integers(0, n, n * per),
        rng.standard_normal(n * per).astype(np.float32))


MATRICES = {
    "sd_mul_dense_rung": lambda: _sd_mul(1000, 200, 30_000),
    "block_sparse": lambda: _block_sparse(1, 512, 64, 256, 0.1),
    "uniform_rows_ell_rung": lambda: _uniform_rows(2, 3000, 4),
    "skewed_segment_rung": lambda: J.CSR.from_coo_arrays(
        (400, 400), np.r_[np.zeros(300, int), np.arange(1, 400)],
        np.r_[np.arange(300), np.zeros(399, int)],
        np.ones(699, np.float32)),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("n_rhs", [1, 16, 128])
def test_mul_dense_slice_matches_jax(name, n_rhs):
    ja = MATRICES[name]()
    pa = interop.csr_from_numpy(*ja.numpy(), ja.shape)
    b = np.random.default_rng(7).standard_normal((ja.cols, n_rhs)).astype(
        np.float32)
    jout = np.asarray(J.mul_dense(ja, b))
    pout = P.mul_dense(pa, torch.from_numpy(b))
    assert pout.dtype == torch.float32 and tuple(pout.shape) == jout.shape
    scale = max(float(np.abs(jout).max()), 1.0)
    np.testing.assert_allclose(pout.numpy(), jout, rtol=1e-5,
                               atol=1e-5 * scale)
    # A second call reuses the memoised layout and gives the same result.
    assert torch.equal(P.mul_dense(pa, torch.from_numpy(b)), pout)


def test_slice_rungs_reached_on_cpu():
    """The CPU reaches the same rungs as the JAX package on the CPU."""
    reached = {}
    for name, make in MATRICES.items():
        ja = make()
        pa = interop.csr_from_numpy(*ja.numpy(), ja.shape)
        b = np.ones((ja.cols, 8), np.float32)
        J.mul_dense(ja, jnp.asarray(b))
        P.mul_dense(pa, torch.from_numpy(b))
        assert (pa._dense_cache is not None) == hasattr(ja, "_dense_cache")
        assert (pa._ell_cache is not None) == hasattr(ja, "_ell_cache")
        reached[name] = ("dense" if pa._dense_cache is not None
                         else "ell" if pa._ell_cache is not None
                         else "segment")
    assert reached["sd_mul_dense_rung"] == "dense"
    assert reached["uniform_rows_ell_rung"] == "ell"
    assert reached["skewed_segment_rung"] == "segment"


_NO_JAX = (
    "import sys, importlib, pkgutil\n"
    "import basic_sparse_matrix_tpu_torch as p\n"
    "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
    "    importlib.import_module(m.name)\n"
    "import chip_smoke\n"
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "       or m.startswith('basic_sparse_matrix_tpu.')\n"
    "       or m == 'basic_sparse_matrix_tpu']\n"
    "assert not bad, bad\n"
    "print('clean')\n"
)


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _run_smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_a_cuda_device():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
