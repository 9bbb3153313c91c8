"""The card's SpMM kernel choice (``ops/spmm.py``: ``_card_kernel``,
``card_costs``, ``card_pick``): a float32 product of at least 64 columns on
a CUDA device takes K1, K2 or K8 by the modelled device time of each on
the operand's layout.

CPU cases (this file imports no JAX):

* the pick as a pure function of a layout's numbers, at the rows of
  ``probes/ell_probe.py --choice`` taken on an H100 (``PERF.md`` §6): each
  case is a probed operand and width with the kernels its rungs' gates
  open, and the kernel the card measured fastest among them;
* ``_card_kernel`` on CPU operands with a stand-in for a CUDA right-hand
  side (an object that says it is on the card: the choice reads only its
  device flag, dtype and shape): the counters ``spmm.card.decisions`` and
  ``spmm.card.bsr_declined``, ``ell_stream="off"`` never picking K2, no
  layout built by the choice, and ``_rung``'s answer from it;
* what never reaches the choice: a CPU tensor, fewer than 64 columns,
  another dtype than float32.

Card cases (``cuda``-marked, skipped without a CUDA device): HPCG's 104³
operator at N = 256 runs K8 once with no BSR layout built and agrees with
K1's product of the same X within 1e-6 of its largest entry; the K1 operand
of ``chip_smoke.py`` keeps K1; an (8, K, 32) batch on the stencil, folded
to 256 columns, takes K8.
"""

import dataclasses
import importlib
import types

import pytest
import torch

from basic_sparse_matrix_tpu_torch.ops import ell as pe
from basic_sparse_matrix_tpu_torch.ops.pallas import spmm_kernel as pk
from basic_sparse_matrix_tpu_torch.probes.ell_probe import (block_operand,
                                                            random_operand)
from basic_sparse_matrix_tpu_torch.probes.trsv_probe import hpcg27
from basic_sparse_matrix_tpu_torch.runtime import profiling as prof
from basic_sparse_matrix_tpu_torch.utils import config as pcfg

# ``ops.spmm`` names the function in the ops namespace: take the module.
ps = importlib.import_module("basic_sparse_matrix_tpu_torch.ops.spmm")


@pytest.fixture(autouse=True, scope="module")
def _on_the_cpu():
    """The port builds on the card unless asked otherwise: these tests ask
    for the CPU, and hand the previous default back afterwards."""
    with pcfg.use_device("cpu"):
        yield


# Layouts of the probed operands (probes/ell_probe.py --choice): rows,
# columns, stored entries, the tile and live blocks at pick_tiles' tile,
# the ELL overhead.
HPCG_104 = dict(rows=1124864, cols=1124864, stored=29791000, bm=8, bk=128,
                live=1141420, overhead=1.0194799771743144)
SMOKE_K1 = dict(rows=32768, cols=32768, stored=10731520, bm=64, bk=256,
                live=655, overhead=4.690076335877863)
SMOKE_K2 = dict(rows=1048576, cols=1048576, stored=33554432, bm=8, bk=128,
                live=33038414, overhead=1.0)
RING_BLOCK = dict(rows=262144, cols=262144, stored=2097152, bm=8, bk=128,
                  live=2064994, overhead=1.0)
TEST_20K = dict(rows=20000, cols=20000, stored=320000, bm=8, bk=128,
               live=219300, overhead=1.0)
TEST_SHARD = dict(rows=32768, cols=131072, stored=1310720, bm=8, bk=128,
                  live=1125609, overhead=1.0)
ALL = ("k1", "k2", "k8")


@pytest.mark.parametrize("layout,n,candidates,fastest", [
    # the stencil: K1's gate holds (fill 0.0255), K8 wins at every width;
    # K2's gate opens at 128 columns
    (HPCG_104, 64, ("k1", "k8"), "k8"),
    (HPCG_104, 128, ALL, "k8"),
    (HPCG_104, 256, ALL, "k8"),
    (HPCG_104, 512, ALL, "k8"),
    # block-dense: K1, whatever else were open (the ELL rung is not: 4.69)
    (SMOKE_K1, 64, ALL, "k1"),
    (SMOKE_K1, 256, ALL, "k1"),
    (SMOKE_K1, 512, ALL, "k1"),
    # random columns, X far beyond the L2: K2's sliced kernel
    (SMOKE_K2, 128, ("k2", "k8"), "k2"),
    (SMOKE_K2, 512, ("k2", "k8"), "k2"),
    (RING_BLOCK, 512, ("k2", "k8"), "k2"),
    (TEST_SHARD, 256, ALL, "k2"),
    # random columns, X inside the L2: K8 (K2 takes its tile kernel)
    (TEST_20K, 128, ALL, "k8"),
])
def test_card_pick_from_layout_numbers(layout, n, candidates, fastest):
    lay = dict(layout, n=n)
    assert ps.card_pick(lay, candidates) == fastest
    costs = ps.card_costs(lay)
    assert set(costs) == set(ALL) and all(c > 0 for c in costs.values())


def test_k1_covers_columns_in_whole_tiles():
    # 64 and 128 columns take one tile: only writing C's extra columns
    c64, c128 = (ps.card_costs(dict(HPCG_104, n=n))["k1"] for n in (64, 128))
    c_bytes = 4 * HPCG_104["rows"] * 64 * ps.DRAM_BYTE_S
    assert c128 - c64 == pytest.approx(c_bytes)


def _on_card(k: int, n: int, dtype=torch.float32):
    """A stand-in for a (k, n) right-hand side on a CUDA device."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, ndim=2,
                                 shape=(k, n))


def _block_diagonal():
    """4,096 × 16,384: one dense 64 × 256 block a block row (fill 1.0 at
    pick_tiles' 64 × 256, ELL overhead 1), 1M entries."""
    from basic_sparse_matrix_tpu_torch import CSR
    import numpy as np

    rows, bm, bk = 4096, 64, 256
    r = np.repeat(np.arange(rows), bk)
    c = (r // bm) * bk + np.tile(np.arange(bk), rows)
    v = np.random.default_rng(4).standard_normal(r.size).astype(np.float32)
    return CSR.from_host(np.arange(rows + 1) * bk, c, v, (rows, 16384),
                         device="cpu")


@pytest.fixture(scope="module")
def operands():
    return {"stencil": hpcg27(24, "cpu"), "block": _block_diagonal(),
            "random": random_operand("cpu", 65536, 65536, 20)}


@pytest.mark.parametrize("name,n,pick,rung,declined", [
    ("stencil", 256, "k8", "ell", 1),    # bsr_profitable holds (fill 0.047)
    ("block", 256, "k1", "bsr", 0),
    ("random", 256, "k2", "stream", 0),  # fill 0.001: K1 is no candidate
    ("random", 128, "k8", "ell", 0),
])
def test_card_kernel_counts_and_builds_nothing(operands, name, n, pick,
                                               rung, declined):
    a = operands[name]
    b = _on_card(a.cols, n)
    assert pk.bsr_profitable(a, b) == (name != "random")
    with prof.recording():
        assert ps._card_kernel(a, b) == pick
    counters = prof.snapshot().counters
    assert counters.get("spmm.card.decisions") == 1
    assert counters.get("spmm.card.bsr_declined", 0) == declined
    # the choice reads memos only: no layout is built before a kernel is
    assert a._bsr_cache is None and a._ell_cache is None
    assert a._dense_cache is None
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, dense_dispatch_density=1.1))
    try:
        assert ps._rung(a, b) == rung
    finally:
        pcfg.set_config(old)


@pytest.mark.parametrize("name", ["stencil", "block", "random"])
@pytest.mark.parametrize("n", [128, 256, 512])
def test_stream_off_never_picks_k2(operands, name, n):
    a = operands[name]
    old = pcfg.get_config()
    pcfg.set_config(dataclasses.replace(old, ell_stream="off"))
    try:
        assert not pe.stream_gate(a, _on_card(a.cols, n))
        assert ps._card_kernel(a, _on_card(a.cols, n)) in ("k1", "k8")
    finally:
        pcfg.set_config(old)


@pytest.mark.parametrize("case", ["cpu", "n32", "n63", "float64", "int32"])
def test_never_reaches_the_choice(operands, case):
    a = operands["stencil"]
    b = {"cpu": torch.zeros(a.cols, 256),
         "n32": _on_card(a.cols, 32), "n63": _on_card(a.cols, 63),
         "float64": _on_card(a.cols, 256, torch.float64),
         "int32": _on_card(a.cols, 256, torch.int32)}[case]
    with prof.recording():
        assert ps._card_kernel(a, b) is None
    assert not any(k.startswith("spmm.card")
                   for k in prof.snapshot().counters)


def test_cpu_product_keeps_its_rung(operands):
    a = operands["stencil"]
    b = torch.randn(a.cols, 256, generator=torch.Generator().manual_seed(2))
    with prof.recording():
        out = ps.spmm_auto(a, b)
    counters = prof.snapshot().counters
    assert counters.get("spmm.rung.ell") == 1
    assert not any(k.startswith("spmm.card") for k in counters)
    torch.testing.assert_close(out, ps.spmm(a, b), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------- card --
@pytest.fixture(scope="module")
def stencil_104():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return hpcg27(104, "cuda")


@pytest.mark.cuda
def test_stencil_n256_runs_k8_without_a_bsr_layout(stencil_104):
    a = stencil_104
    b = torch.randn(a.cols, 256, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    with prof.recording():
        out = ps.spmm_auto(a, b)
        torch.cuda.synchronize()
    counters = prof.snapshot().counters
    assert counters.get("ell.launches") == 1
    assert counters.get("spmm.rung.ell") == 1
    assert counters.get("spmm.card.decisions") == 1
    assert counters.get("spmm.card.bsr_declined") == 1
    assert "spmm.rung.bsr" not in counters and a._bsr_cache is None
    k1_out = pk.spmm_bsr(pk.csr_to_bsr(a), b)
    assert float((out - k1_out).abs().max()) \
        <= 1e-6 * float(k1_out.abs().max())


@pytest.mark.cuda
def test_stencil_batch_takes_the_chosen_kernel(stencil_104):
    a = stencil_104
    b = torch.randn(8, a.cols, 32, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    with prof.recording():
        out = ps.spmm_auto(a, b)
        torch.cuda.synchronize()
    counters = prof.snapshot().counters
    assert counters.get("ell.launches") == 1
    assert counters.get("spmm.card.decisions") == 1
    assert out.shape == (8, a.rows, 32)
    for i in (0, 7):
        torch.testing.assert_close(out[i], ps.spmm_auto(a, b[i]))


@pytest.mark.cuda
def test_smoke_k1_operand_keeps_k1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = block_operand("cuda")
    b = torch.randn(a.cols, 512, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(7))
    before = pk.LAUNCHES
    with prof.recording():
        ps.spmm_auto(a, b)
        torch.cuda.synchronize()
    counters = prof.snapshot().counters
    assert counters.get("spmm.rung.bsr") == 1 and pk.LAUNCHES == before + 1
    assert counters.get("spmm.card.decisions") == 1
    assert "spmm.card.bsr_declined" not in counters
