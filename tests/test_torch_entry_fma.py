"""K6, the per-entry FMA: the port's plain version against the JAX probe's
Pallas kernel, and the wrapper's behaviour on the CPU.

The JAX kernel is the one ``benchmarks/entry_fma_probe.py`` builds (imported
by path; nothing there changes) and runs here as the probe's own ``--check``
runs it: in interpret mode on the CPU. Inputs are made with numpy from a
seed, as the probe makes them. Tolerance: max abs error < 1e-5 (the serial
loop and ``index_add_`` add in different orders; the probe's own bound for
the card is 1e-4); where one row takes hundreds of entries and its sums
reach tens, 1e-5 of the largest magnitude. The kernel runs on the card
(``test_torch_cuda_kernels.py``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu_torch.ops.pallas import entry_fma as k6
from basic_sparse_matrix_tpu_torch.probes import entry_fma_probe as probe

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield


def _jax_probe():
    path = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "entry_fma_probe.py")
    spec = importlib.util.spec_from_file_location("jax_entry_fma_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, entries, rows, lanes, hot_rows=None):
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, hot_rows or rows, entries).astype(np.int32)
    kk = rng.integers(0, rows, entries).astype(np.int32)
    vv = rng.standard_normal(entries).astype(np.float32)
    b = rng.standard_normal((rows, lanes)).astype(np.float32)
    return ii, kk, vv, b


@pytest.mark.parametrize("entries,rows,lanes,hot_rows,scaled", [
    (64, 32, 128, None, False),   # the probe's --check shape
    (512, 16, 128, None, False),  # heavy repeats: 32 entries a row
    (512, 16, 128, 2, True),      # 256 entries into each of two rows
    (200, 8, 256, 1, True),       # every entry into row 0
])
def test_plain_version_matches_the_jax_kernel(entries, rows, lanes, hot_rows,
                                              scaled):
    ii, kk, vv, b = _inputs(0, entries, rows, lanes, hot_rows)
    run = _jax_probe().build(entries, rows, lanes)
    want = np.asarray(jax.block_until_ready(
        run(jnp.asarray(ii), jnp.asarray(kk), jnp.asarray(vv),
            jnp.asarray(b))))
    got = k6.entry_fma_reference(*(torch.from_numpy(x)
                                   for x in (ii, kk, vv, b)), rows)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 1e-5 * (max(float(np.abs(want).max()), 1.0) if scaled else 1.0)
    assert float(np.abs(got.numpy() - want).max()) < tol
    # and both against the float64 loop
    assert float(np.abs(got.numpy()
                        - probe.oracle(ii, kk, vv, b, rows)).max()) < tol


def test_probe_inputs_are_the_jax_probe_s():
    """``make_entries`` draws what the JAX probe's ``main`` draws from
    ``default_rng(0)``, in the same order."""
    e, r, l = probe.CHECK_SHAPE
    assert (e, r, l) == (64, 32, 128)
    ii, kk, vv, b = probe.make_entries(e, r, l)
    rng = np.random.default_rng(0)
    assert np.array_equal(ii, rng.integers(0, r, e).astype(np.int32))
    assert np.array_equal(kk, rng.integers(0, r, e).astype(np.int32))
    assert np.array_equal(vv, rng.standard_normal(e).astype(np.float32))
    assert np.array_equal(b, rng.standard_normal((r, l)).astype(np.float32))


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    ii, kk, vv, b = (torch.from_numpy(x) for x in _inputs(1, 300, 20, 48))
    before = k6.LAUNCHES
    out = k6.entry_fma(ii, kk, vv, b, 20)
    assert k6.LAUNCHES == before
    assert torch.equal(out, k6.entry_fma_reference(ii, kk, vv, b, 20))
    empty = k6.entry_fma(ii[:0], kk[:0], vv[:0], b, 20)
    assert tuple(empty.shape) == (20, 48) and not empty.any()
    assert k6.LAUNCHES == before


@pytest.mark.parametrize("mutate,error", [
    (lambda ii, kk, vv, b: (ii.long(), kk, vv, b), TypeError),
    (lambda ii, kk, vv, b: (ii, kk.to(torch.int16), vv, b), TypeError),
    (lambda ii, kk, vv, b: (ii, kk, vv.double(), b), TypeError),
    (lambda ii, kk, vv, b: (ii, kk, vv, b.to(torch.float16)), TypeError),
    (lambda ii, kk, vv, b: (ii + 20, kk, vv, b), IndexError),
    (lambda ii, kk, vv, b: (ii, kk - 21, vv, b), IndexError),
    (lambda ii, kk, vv, b: (ii[:-1], kk, vv, b), ValueError),
    (lambda ii, kk, vv, b: (ii, kk, vv, b[:-1]), ValueError),
    (lambda ii, kk, vv, b: (ii, kk, vv, b.reshape(-1)), ValueError),
])
def test_bad_dtypes_shapes_and_out_of_range_indices_raise(mutate, error):
    args = tuple(torch.from_numpy(x) for x in _inputs(2, 50, 20, 16))
    for fn in (k6.entry_fma, k6.entry_fma_reference):
        with pytest.raises(error):
            fn(*mutate(*args), 20)


def test_probe_check_runs_on_the_cpu(capsys):
    err = probe.check(*probe.CHECK_SHAPE, torch.device("cpu"))
    assert err < 1e-5
    probe.main(["--check"])
    out = capsys.readouterr().out
    assert '"check_max_abs_err"' in out and '"entries": 64' in out


def test_probe_timing_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        probe.main([])
