"""The ``kron`` PageRank cell at scale 10 on the CPU: a run reads correct,
planted faults in the product read as not correct, the TF32 control
fails the limit, and the cost counted from the row pointer is the count
over every entry."""

import pytest
import torch

from conftest import quick
from portbench import calibrate, costs, kron, manifest, run

SECONDS = 0.2
CELL = "gap-kron-25.spmv"
SCALE = 10


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _small(bench):
    cell = manifest.cell(bench, CELL)
    config = dict(manifest.data("configs", cell["config"]), scale=SCALE)
    return cell, config, quick(manifest.data("traffic", cell["traffic"]))


def _run(bench, seed=2 ** 31 + 37):
    cell, config, traffic = _small(bench)
    return run.run_cell(bench, cell, seed, SECONDS, False, "cpu",
                        config=config, traffic=traffic,
                        since_start=lambda: 1.0)


def _row_off(y, a, x):
    """One row with entries off by 1e-3 of its scale."""
    r = int(torch.argmax(torch.diff(a.indptr)))
    y[r] += 1e-3 * float(y[r].abs())
    return y


def _empty_row_set(y, a, x):
    r = int(torch.nonzero(torch.diff(a.indptr) == 0)[0])
    y[r] = 1e-30
    return y


def _neighbour_left_out(y, a, x):
    """The hub's sum less its last neighbour's term."""
    r = int(torch.argmax(torch.diff(a.indptr)))
    e = int(a.indptr[r + 1]) - 1
    y[r] -= a.values[e] * x[int(a.indices[e])]
    return y


FAULTS = {"one row off by 1e-3 of its scale": _row_off,
          "an empty row nonzero": _empty_row_set,
          "one neighbour left out of a hub's sum": _neighbour_left_out}


def test_a_run_reads_correct(bench):
    result, lines = _run(bench)
    assert result["correct"], lines
    assert result["checks"]["spmv_err"]["value"] < 1e-6
    assert result["metrics"]["spmm_gflops"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_read_not_correct(bench, monkeypatch, fault):
    from basic_sparse_matrix_tpu_torch.models.operator import SparseOperator

    orig = SparseOperator.matvec

    def planted(self, x):
        return FAULTS[fault](orig(self, x).clone(), self.a, x)

    monkeypatch.setattr(SparseOperator, "matvec", planted)
    result, lines = _run(bench)
    assert not result["correct"], lines


def test_the_control_fails_the_limit(bench):
    cell, config, traffic = _small(bench)
    summary = calibrate.readings(bench, cell, [2 ** 31 + 41], 1, SECONDS,
                                 "cpu", config=config, traffic=traffic,
                                 emit=lambda line: None)
    limit = manifest.data("limits", CELL)["spmv_err"]
    assert summary["lower"]["spmv_err"] < limit < summary["upper"]["spmv_err"]


@pytest.mark.parametrize("scale", [6, 8, 10])
def test_the_cost_from_the_row_pointer_is_the_count_over_every_entry(
        bench, scale):
    config = dict(manifest.data("configs", "gap-kron-25"), scale=scale)
    indptr, indices, values = kron.csr(config, "cpu")
    assert (torch.diff(torch.from_numpy(indptr)) == 0).any()
    assert kron.spmv_cost(indptr) == costs.spmm(indptr.size - 1, indices,
                                                values, 1)
