"""BSR SpMM (K1) parity of the PyTorch port against the JAX package on the
CPU: the host layout ``csr_to_bsr`` must equal the JAX one exactly (blocks,
block coordinates, seeded zero blocks), and the plain version
``spmm_bsr_reference`` must match the JAX Pallas kernel in interpret mode
to ``rtol=atol=1e-4`` (the JAX kernel test's own bound). The live-block
list the kernel walks must name exactly the JAX layout's blocks that hold
an entry, and dropping the other blocks must leave the plain version's
output bit for bit the same. On integers 0..15 both precisions equal the
JAX kernel's exactly. The CUDA kernel itself is tested on the card
(``test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import basic_sparse_matrix_tpu as J
import basic_sparse_matrix_tpu_torch as P
from basic_sparse_matrix_tpu.ops.pallas import spmm_kernel as jk
from basic_sparse_matrix_tpu_torch.ops import interop as pi
from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as pk

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    from basic_sparse_matrix_tpu_torch.utils.config import use_device

    with use_device("cpu"):
        yield

CASES = [
    (128, 256, 0.05, 128),   # tile-aligned
    (100, 200, 0.1, 64),     # unaligned everything
    (8, 128, 1.0, 128),      # single dense block
    (1000, 1000, 0.01, 10),  # reference bench shape
    (64, 64, 0.0, 32),       # empty matrix
]


def _case(rows, cols, density, n_rhs, seed=42):
    rng = np.random.default_rng(seed)
    d = ((rng.random((rows, cols)) < density)
         * rng.standard_normal((rows, cols))).astype(np.float32)
    b = rng.standard_normal((cols, n_rhs)).astype(np.float32)
    return d, b


def _assert_same_bsr(p, j):
    assert (p.rows, p.cols, p.bm, p.bk) == (j.rows, j.cols, j.bm, j.bk)
    assert np.array_equal(p.blocks.numpy(), np.asarray(j.blocks))
    assert np.array_equal(p.block_rows.numpy(), np.asarray(j.block_rows))
    assert np.array_equal(p.block_cols.numpy(), np.asarray(j.block_cols))


@pytest.mark.parametrize("rows,cols,density,n_rhs", CASES)
def test_csr_to_bsr_equals_jax(rows, cols, density, n_rhs):
    d, _ = _case(rows, cols, density, n_rhs)
    _assert_same_bsr(pk.csr_to_bsr(P.CSR.from_dense(d)),
                     jk.csr_to_bsr(J.CSR.from_dense(d)))


@pytest.mark.parametrize("bm,bk", [(8, 128), (64, 256), (256, 512),
                                   (16, 32)])
def test_csr_to_bsr_explicit_tiles_equal_jax(bm, bk):
    d, _ = _case(300, 700, 0.02, 8, seed=3)
    _assert_same_bsr(pk.csr_to_bsr(P.CSR.from_dense(d), bm, bk),
                     jk.csr_to_bsr(J.CSR.from_dense(d), bm, bk))


def test_bsr_structure_seeded_blocks_and_row_pointer():
    d = np.zeros((16, 256), dtype=np.float32)
    d[0, 0] = 1.0       # block (0, 0)
    d[9, 130] = 2.0     # block (1, 1)
    d[15, 255] = 3.0    # block (1, 1)
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    _assert_same_bsr(bsr, jk.csr_to_bsr(J.CSR.from_dense(d)))
    assert bsr.block_rows.tolist() == [0, 1, 1]
    assert bsr.block_cols.tolist() == [0, 0, 1]
    assert bsr.brow_ptr.tolist() == [0, 1, 3]
    assert torch.all(bsr.blocks[1] == 0)


@pytest.mark.parametrize("rows,cols,density,n_rhs", CASES)
def test_spmm_bsr_reference_matches_jax_kernel(rows, cols, density, n_rhs):
    d, b = _case(rows, cols, density, n_rhs)
    jout = np.asarray(jk.spmm_bsr(jk.csr_to_bsr(J.CSR.from_dense(d)),
                                  jnp.asarray(b)))
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    out = pk.spmm_bsr_reference(bsr, torch.from_numpy(b))
    assert tuple(out.shape) == (rows, n_rhs)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows,cols,density,n_rhs", CASES[:4])
def test_bsr_from_numpy_carries_jax_layout(rows, cols, density, n_rhs):
    d, b = _case(rows, cols, density, n_rhs, seed=5)
    jb = jk.csr_to_bsr(J.CSR.from_dense(d))
    pb = pi.bsr_from_numpy(jb.blocks, jb.block_rows, jb.block_cols,
                           jb.rows, jb.cols)
    _assert_same_bsr(pb, jb)
    np.testing.assert_allclose(
        pk.spmm_bsr(pb, torch.from_numpy(b)).numpy(),
        np.asarray(jk.spmm_bsr(jb, jnp.asarray(b))), rtol=1e-4, atol=1e-4)


def test_make_bsr_rejects_bad_layouts():
    blocks = np.zeros((2, 8, 128), np.float32)
    with pytest.raises(ValueError):
        pk.make_bsr(blocks, [1, 0], [0, 0], 16, 128)   # unsorted rows
    with pytest.raises(ValueError):
        pk.make_bsr(blocks, [0, 1], [0, 1], 16, 128)   # column out of range
    with pytest.raises(ValueError):
        pk.make_bsr(blocks, [0], [0], 16, 128)         # shape mismatch


def test_spmm_bsr_on_cpu_runs_plain_version_without_launch():
    d, b = _case(64, 128, 0.2, 128, seed=1)
    a = P.CSR.from_dense(d)
    before = pk.LAUNCHES
    out1 = pk.spmm_bsr_from_csr(a, torch.from_numpy(b))
    assert a._bsr_cache is not None
    cached = a._bsr_cache
    out2 = pk.spmm_bsr_from_csr(a, torch.from_numpy(b))
    assert a._bsr_cache is cached and pk.LAUNCHES == before
    assert torch.equal(out1, out2)
    np.testing.assert_allclose(out1.numpy(), d @ b, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        pk.spmm_bsr(cached, torch.zeros((127, 4)))


@pytest.mark.parametrize("density", [0.9, 0.05, 0.01, 0.001])
def test_bsr_profitable_cpu_gate_and_fill_logic(density):
    d, b = _case(256, 512, density, 128, seed=2)
    p, j = P.CSR.from_dense(d), J.CSR.from_dense(d)
    bt = torch.from_numpy(b)
    # CPU tensors never dispatch to the kernel ...
    assert pk.bsr_profitable(p, bt) is False
    # ... and the fill logic agrees with the JAX package's.
    assert pk.bsr_profitable(p, bt, force=True) == \
        jk.bsr_profitable(j, 128, force=True)
    assert pk.bsr_profitable(p, bt, force=True) == \
        pk.bsr_profitable(p, bt, force=True)  # memoised fill
    pk.cached_bsr(p)
    jk.spmm_bsr_from_csr(j, jnp.asarray(b))
    assert pk.bsr_profitable(p, bt, force=True) == \
        jk.bsr_profitable(j, 128, force=True)
    assert pk.bsr_profitable(p, bt[:, :32], force=True) is False


def _empty_block_rows():
    """Entries in block rows 0 and 3 only (of 5 at bm = 64): three block
    rows hold nothing but their seeded zero block."""
    rng = np.random.default_rng(11)
    d = np.zeros((300, 700), np.float32)
    d[:40] = _case(40, 700, 0.02, 1, seed=12)[0]
    d[200:230, 300:600] = rng.standard_normal((30, 300))
    return d


LIVE_CASES = [_case(*c)[0] for c in CASES] + [_empty_block_rows()]


@pytest.mark.parametrize("d", LIVE_CASES)
def test_live_blocks_are_the_jax_blocks_with_entries(d):
    jb = jk.csr_to_bsr(J.CSR.from_dense(d))
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    r, c = np.nonzero(d)
    keys = set(zip((r // jb.bm).tolist(), (c // jb.bk).tolist()))
    want = [t for t, key in enumerate(zip(np.asarray(jb.block_rows).tolist(),
                                          np.asarray(jb.block_cols).tolist()))
            if key in keys]
    assert bsr.live_idx.tolist() == want
    assert bsr.live_idx.dtype == torch.int32
    assert bsr.live_ptr.dtype == torch.int32
    rows_of_live = np.asarray(jb.block_rows)[want]
    assert bsr.live_ptr.tolist() == [0] + np.cumsum(np.bincount(
        rows_of_live, minlength=bsr.n_block_rows)).tolist()


def test_live_list_skips_seeded_blocks_and_empty_block_rows():
    d = _empty_block_rows()
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    assert bsr.n_block_rows == 5 and bsr.nblocks > bsr.n_live
    counts = np.diff(bsr.live_ptr.numpy())
    assert counts[[1, 2, 4]].tolist() == [0, 0, 0]
    assert (counts[[0, 3]] > 0).all()
    dead = np.setdiff1d(np.arange(bsr.nblocks), bsr.live_idx.numpy())
    assert float(bsr.blocks[dead].abs().sum()) == 0.0


@pytest.mark.parametrize("d", LIVE_CASES)
def test_make_bsr_from_jax_arrays_derives_the_same_live_list(d):
    jb = jk.csr_to_bsr(J.CSR.from_dense(d))
    pb = pi.bsr_from_numpy(jb.blocks, jb.block_rows, jb.block_cols,
                           jb.rows, jb.cols)
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    assert torch.equal(pb.live_idx, bsr.live_idx)
    assert torch.equal(pb.live_ptr, bsr.live_ptr)


@pytest.mark.parametrize("d", LIVE_CASES)
def test_plain_version_over_live_blocks_equals_full_bitwise(d):
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    live = bsr.live_idx.long()
    only_live = pk.make_bsr(bsr.blocks[live].numpy(),
                            bsr.block_rows[live].numpy(),
                            bsr.block_cols[live].numpy(), bsr.rows, bsr.cols)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (d.shape[1], 24)).astype(np.float32))
    assert torch.equal(pk.spmm_bsr_reference(only_live, b),
                       pk.spmm_bsr_reference(bsr, b))


def test_make_bsr_rejects_bad_live_lists():
    blocks = np.ones((2, 8, 128), np.float32)
    for live in ([1, 0], [0, 2], [-1], [0, 0]):
        with pytest.raises(ValueError):
            pk.make_bsr(blocks, [0, 1], [0, 0], 16, 128, live_idx=live)
    bsr = pk.make_bsr(blocks, [0, 1], [0, 0], 16, 128, live_idx=[1])
    assert bsr.live_ptr.tolist() == [0, 0, 1]


@pytest.mark.parametrize("precision", ["HIGHEST", "DEFAULT"])
@pytest.mark.parametrize("rows,cols,density,n_rhs", [
    (128, 256, 0.05, 128), (100, 200, 0.3, 64), (300, 2000, 0.004, 130)])
def test_precisions_match_jax_exactly_on_small_integers(
        precision, rows, cols, density, n_rhs):
    import jax

    rng = np.random.default_rng(8)
    d = ((rng.random((rows, cols)) < density)
         * rng.integers(0, 16, (rows, cols))).astype(np.float32)
    b = rng.integers(0, 16, (cols, n_rhs)).astype(np.float32)
    jp = getattr(jax.lax.Precision, precision)
    jout = np.asarray(jk.spmm_bsr(jk.csr_to_bsr(J.CSR.from_dense(d)),
                                  jnp.asarray(b), precision=jp))
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    tb = torch.from_numpy(b)
    out = pk.spmm_bsr_reference(bsr, tb, precision.lower())
    assert np.array_equal(out.numpy(), jout)
    # The wrapper takes the JAX enum member by name, and ignores bn.
    assert torch.equal(pk.spmm_bsr(bsr, tb, bn=256, precision=jp), out)


def test_round_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)            # TF32 spacing at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 0.0, np.inf, -np.inf, np.nan],
                     dtype=torch.float32)
    got = pk.round_tf32(x)
    want = [one + ulp, -(one + ulp), one, one + ulp, 0.0, np.inf, -np.inf]
    assert got[:7].tolist() == [float(w) for w in want]
    assert bool(torch.isnan(got[7]))
    # Every rounded value keeps at most 10 mantissa bits.
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    r = pk.round_tf32(y)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((r - y).abs() / y.abs()).max()) <= 2.0 ** -11


def test_default_precision_rounds_and_bad_precision_raises():
    d, b = _case(128, 256, 0.1, 32, seed=9)
    bsr = pk.csr_to_bsr(P.CSR.from_dense(d))
    tb = torch.from_numpy(b)
    hi = pk.spmm_bsr(bsr, tb)
    lo = pk.spmm_bsr(bsr, tb, precision=pk.DEFAULT)
    assert torch.equal(hi, pk.spmm_bsr(bsr, tb, precision=pk.HIGHEST))
    assert 0 < float((hi - lo).abs().max()) <= 1e-2 * float(hi.abs().max())
    with pytest.raises(ValueError):
        pk.spmm_bsr(bsr, tb, precision="bfloat16")


@pytest.mark.parametrize("rows,cols,nnz", [(10, 10, 100), (1000, 1000, 5000),
                                           (1000, 1000, 50000),
                                           (100, 100, 0)])
def test_pick_tiles_matches_jax(rows, cols, nnz):
    assert pk.pick_tiles(rows, cols, nnz) == jk.pick_tiles(rows, cols, nnz)
