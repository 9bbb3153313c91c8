"""The supernodal kernels' plain versions in the PyTorch port against the JAX
package's Pallas kernels in interpret mode, on the CPU:

* K3 ``runs_read``: unaligned starts, dead slots; only live rows are
  compared (the TPU kernel leaves dead rows unwritten), exactly, since a
  read copies values;
* K4 ``addback_resident`` and K5 ``panel_addback``: unaligned starts, dead
  slots and overlapping spans, to abs 1e-5 (float32 sums of the same terms
  in another order);
* ``shear_reshape``: exactly (a reshape moves values).

On a CPU tensor each wrapper runs its plain version and launches nothing;
the CUDA kernels are held against the same plain versions on the card
(``test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_sparse_matrix_tpu.ops.pallas import addback_resident as jk4
from basic_sparse_matrix_tpu.ops.pallas import panel_addback as jk5
from basic_sparse_matrix_tpu.ops.pallas import runs_read as jk3
from basic_sparse_matrix_tpu_torch.ops.pallas import addback_resident as k4
from basic_sparse_matrix_tpu_torch.ops.pallas import panel_addback as k5
from basic_sparse_matrix_tpu_torch.ops.pallas import runs_read as k3

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.mark.parametrize("nnz,crq,l_pad,seed", [
    (3000, 256, 128, 0), (5000, 512, 256, 1), (2000, 256, 512, 2),
])
def test_runs_read_reference_matches_jax_kernel(nnz, crq, l_pad, seed):
    rng = np.random.default_rng(seed)
    # The JAX kernel needs l_pad + 256 slack past every live start.
    lv = rng.standard_normal(nnz + l_pad + 256).astype(np.float32)
    stf = rng.integers(0, nnz, crq).astype(np.int32)
    stf[::3] = -1
    stf[1::11] = nnz - 1
    want = np.asarray(jk3.runs_read(jnp.asarray(lv), jnp.asarray(stf),
                                    l_pad))
    before = k3.LAUNCHES
    got = k3.runs_read(torch.as_tensor(lv), torch.as_tensor(stf),
                       l_pad).numpy()
    assert k3.LAUNCHES == before
    live = stf >= 0
    assert np.array_equal(got[live], want[live])
    assert not got[~live].any()


@pytest.mark.parametrize("u,w,L,lpad", [(7, 5, 100, 128), (3, 40, 200, 256)])
def test_win_kernel_matches_jax(u, w, L, lpad):
    rng = np.random.default_rng(u * w)
    lv = rng.standard_normal(4000 + lpad + 256).astype(np.float32)
    starts = rng.integers(0, 4000, (u, w)).astype(np.int32)
    starts[0, :2] = -1
    want = np.asarray(jk3.win_kernel(jnp.asarray(lv), jnp.asarray(starts),
                                     L, lpad))
    got = k3.win_kernel(torch.as_tensor(lv), torch.as_tensor(starts), L,
                        lpad).numpy()
    assert got.shape == want.shape == (u, w, L)
    live = starts >= 0
    assert np.array_equal(got[live], want[live])


def _spans(rng, nslots, length, nnz, tail):
    """Rows with a live prefix and >= ``tail`` trailing zeros at random
    (unaligned, often overlapping) starts; every fourth slot dead."""
    rows = np.zeros((nslots, length), np.float32)
    starts = np.full((nslots,), -1, np.int32)
    for c in range(nslots):
        if c % 4 == 3:
            continue
        ln = int(rng.integers(1, length - tail + 1))
        rows[c, :ln] = rng.standard_normal(ln)
        starts[c] = int(rng.integers(0, nnz - 1))
    return rows, starts


@pytest.mark.parametrize("nnz,cq,col_pad,seed", [
    (3000, 16, 256, 5), (2000, 64, 512, 6), (700, 32, 256, 7),
])
def test_addback_resident_reference_matches_jax_kernel(nnz, cq, col_pad,
                                                       seed):
    rng = np.random.default_rng(seed)
    lv = rng.standard_normal(nnz + col_pad).astype(np.float32)
    lv[nnz:] = 0.0
    rows, starts = _spans(rng, cq, col_pad, nnz, 128)
    starts[1] = starts[0] + 3 if starts[0] >= 0 else 5   # overlap
    want = np.asarray(jk4.addback_resident(
        jnp.asarray(lv), jnp.asarray(rows), jnp.asarray(starts)))
    before = k4.LAUNCHES
    got = k4.addback_resident(torch.as_tensor(lv), torch.as_tensor(rows),
                              torch.as_tensor(starts)).numpy()
    assert k4.LAUNCHES == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_addback_resident_is_in_place_and_matches_loop():
    rng = np.random.default_rng(8)
    rows, starts = _spans(rng, 40, 64, 500, 0)
    lv = torch.zeros(600)
    out = k4.addback_resident(lv, torch.as_tensor(rows),
                              torch.as_tensor(starts))
    assert out is lv
    ref = np.zeros(600, np.float64)
    for c in range(40):
        if starts[c] >= 0:
            ref[starts[c]: starts[c] + 64] += rows[c]
    np.testing.assert_allclose(lv.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("st,wt,col_len,seed", [
    (2, 4, 2048, 9), (4, 8, 2048, 10), (1, 3, 3072, 11),
])
def test_panel_addback_reference_matches_jax_kernel(st, wt, col_len, seed):
    rng = np.random.default_rng(seed)
    nnz = 5000
    lv = rng.standard_normal(nnz + col_len + 1024).astype(np.float32)
    lv[nnz:] = 0.0
    rows, flat_starts = _spans(rng, st * wt, col_len, nnz, 1024)
    tcp = np.where(flat_starts >= 0, flat_starts, 0).reshape(st, wt)
    tcp = tcp.astype(np.int32)
    twd = rng.integers(0, wt + 1, st).astype(np.int32)
    psh = rows.reshape(st, wt, col_len)
    want = np.asarray(jk5.panel_addback(
        jnp.asarray(lv), jnp.asarray(psh), jnp.asarray(tcp),
        jnp.asarray(twd)))
    before = k5.LAUNCHES
    got = k5.panel_addback(torch.as_tensor(lv), torch.as_tensor(psh),
                           torch.as_tensor(tcp),
                           torch.as_tensor(twd)).numpy()
    assert k5.LAUNCHES == before
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("st,rd,wt,col_pad", [
    (3, 40, 7, 128), (2, 300, 33, 512), (1, 5, 1, 128),
])
def test_shear_reshape_matches_jax(st, rd, wt, col_pad):
    rng = np.random.default_rng(rd)
    p = np.zeros((st, rd + 10, wt), np.float32)
    p[:, :rd] = rng.standard_normal((st, rd, wt))
    got = k4.shear_reshape(torch.as_tensor(p), col_pad).numpy()
    want = np.asarray(jk4.shear_reshape(jnp.asarray(p), col_pad))
    assert got.shape == want.shape == (st, wt, col_pad)
    assert np.array_equal(got, want)
    s, w, q = np.meshgrid(np.arange(st), np.arange(wt), np.arange(col_pad),
                          indexing="ij")
    r = q + w
    ok = r < rd + 10
    assert np.array_equal(got[ok], p[s[ok], r[ok], w[ok]])
    assert not got[~ok].any()


def test_wrappers_reject_bad_operands():
    lv = torch.zeros(100)
    with pytest.raises(TypeError):
        k3.runs_read(lv, torch.zeros(3, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        k3.runs_read(lv, torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        k4.addback_resident(lv, torch.zeros((2, 8)),
                            torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        k4.addback_resident(lv.double(), torch.zeros((2, 8)),
                            torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        k5.panel_addback(lv, torch.zeros((2, 3, 8)),
                         torch.zeros((2, 4), dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32))
