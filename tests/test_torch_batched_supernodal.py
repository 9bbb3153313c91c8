"""The port's batched supernodal factorization against ``jax.vmap`` of the
JAX package's, on the CPU.

``factorize_supernodal(sched, V)`` with ``V`` (Bt = 3, nnz), three SPD
value sets ``s_b·A + c_b·I`` of the 9×9 5-point Laplacian in
nested-dissection order (seeded), at ``relax`` 0 and 8, under each scatter
mode (``element``, ``delta``, ``pallas``: K5, ``vmem``: K4) with window
reads on and off, against ``jax.vmap(lambda v:
_factorize_supernodal_whole(sched, v, window, mode))`` on the JAX
package's own schedule (Pallas in interpret mode: JAX maps its kernels
over the systems). ``rtol=1e-5``, ``atol=1e-6·max|ref|``: float32
products summed in another order. Each case must also reach the kernel
wrappers its mode routes to (their plain versions here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.models import supernodal as jsn
from basic_sparse_matrix_tpu.ops import reorder as jr
from basic_sparse_matrix_tpu_torch.models import supernodal as psn
from basic_sparse_matrix_tpu_torch.ops import reorder as pr
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

torch.set_num_threads(1)

K = 9          # 9×9 grid, n = 81
BT = 3
RTOL = 1e-5
ATOL_OF_MAX = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


@pytest.fixture(scope="module")
def family():
    """The ND-ordered Laplacian in both packages and the (BT, nnz) values."""
    n = K * K
    idx = np.arange(n).reshape(K, K)
    r, c, v = [idx.ravel()], [idx.ravel()], [np.full(n, 4.0)]
    for ax in range(2):
        a = np.take(idx, range(K - 1), axis=ax).ravel()
        b = np.take(idx, range(1, K), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
        v += [np.full(a.size, -1.0)] * 2
    r, c = np.concatenate(r), np.concatenate(c)
    v = np.concatenate(v).astype(np.float32)
    ja = J.CSR.from_coo_arrays((n, n), r, c, v)
    pa = P.CSR.from_coo_arrays((n, n), r, c, v)
    perm = pr.nd_permutation(pa)
    assert np.array_equal(perm, jr.nd_permutation(ja))
    ja, pa = jr.permute_symmetric(ja, perm), pr.permute_symmetric(pa, perm)
    indptr, indices, values = pa.numpy()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    rng = np.random.default_rng(10)
    s = (1.0 + rng.random(BT)).astype(np.float32)
    shift = rng.random(BT).astype(np.float32)
    vals = (s[:, None] * values[None, :]
            + shift[:, None] * (indices == rows)[None, :]).astype(np.float32)
    return ja, pa, vals


@pytest.mark.parametrize("window", [False, True], ids=["element", "window"])
@pytest.mark.parametrize("mode", ["element", "delta", "pallas", "vmem"])
@pytest.mark.parametrize("relax", [0, 8])
def test_batched_supernodal_matches_vmap(family, relax, mode, window,
                                         monkeypatch):
    ja, pa, vals = family
    jsched = jsn.analyze_supernodal(ja, relax=relax)
    want = jax.vmap(lambda v: jsn._factorize_supernodal_whole(
        jsched, v, window, mode))(jnp.asarray(vals))

    from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident
    from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback
    calls = {"addback_rects": 0, "addback_resident": 0, "panel_addback": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args):
            calls[name] += 1
            assert args[0].shape[0] == BT       # one call for the batch
            return fn(*args)
        monkeypatch.setattr(mod, name, wrapper)
    counted(addback_resident, "addback_rects")
    counted(addback_resident, "addback_resident")
    counted(panel_addback, "panel_addback")

    sched = psn.analyze_supernodal(pa, relax=relax)
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(
        old, supernodal_gather="window" if window else "element",
        supernodal_scatter=mode))
    try:
        got = psn.factorize_supernodal(sched, torch.as_tensor(vals))
    finally:
        pcfg.set_config(old)
    assert got.shape == (BT, sched.nnz_l) == tuple(want.shape)
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(
        got.double().numpy(), want, rtol=RTOL,
        atol=ATOL_OF_MAX * float(np.abs(want).max()))
    levels = sum(int(sched.tabs[gi][0].shape[0])
                 for gi in range(sched.n_groups)
                 if psn._group_delta(sched, gi, mode) == "rects")
    assert calls == {"addback_rects": levels, "addback_resident": 0,
                     "panel_addback": 0}
    if mode in ("vmem", "pallas"):
        assert levels > 0
