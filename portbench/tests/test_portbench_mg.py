"""The multigrid cell at 16³ on the CPU (HPCG's four levels: 16, 8, 4 and
2 points a side): planted faults in the V-cycle read as not correct, the
TF32 control fails every limit, and the new readers give None without the
program's recorder."""

import importlib

import pytest

from conftest import quick, small
from portbench import calibrate, manifest, program, run

SECONDS = 0.2
MG = "hpcg-104-mg.pcg50"


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _run(bench, name, seed=2 ** 31 + 29):
    cell = manifest.cell(bench, name)
    config = small(manifest.data("configs", cell["config"]))
    traffic = quick(manifest.data("traffic", cell["traffic"]))
    return run.run_cell(bench, cell, seed, SECONDS, False, "cpu",
                        config=config, traffic=traffic,
                        since_start=lambda: 1.0)


def _altered(f):
    def patched(self, b, **kwargs):
        out = f(self, b, **kwargs)
        out[0].view(-1)[0] += 1.0
        return out
    return patched


FAULTS = {
    "the post-smoother left out": ("models.multigrid", "POST_STEPS",
                                   lambda f: 0),
    "the prolongation left out": ("models.multigrid",
                                  "MultigridSetup._prolong",
                                  lambda f: staticmethod(
                                      lambda lv, x, xc: x)),
    "the backward sweep left out": ("models.multigrid",
                                    "MultigridSetup._backward",
                                    lambda f: staticmethod(
                                        lambda lv, r, x: x)),
    "an answer altered where it is produced": ("models.operator",
                                               "SparseOperator.solve_cg",
                                               _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_read_not_correct(bench, monkeypatch, fault):
    mod, attr, make = FAULTS[fault]
    owner = importlib.import_module(f"basic_sparse_matrix_tpu_torch.{mod}")
    if "." in attr:
        cls, attr = attr.split(".")
        owner = getattr(owner, cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    result, lines = _run(bench, MG)
    assert result["correct"] is False, (fault, lines)
    assert result["failed"] >= 1


def test_the_cell_runs_and_compares_three_numbers(bench):
    result, lines = _run(bench, MG)
    assert result["correct"] is True, lines
    assert set(result["checks"]) == {"pcg_err", "pcg_iters_off", "mg_err"}
    assert result["checks"]["mg_err"]["value"] <= 1e-6


def test_the_control_fails_every_limit(bench):
    cell = manifest.cell(bench, MG)
    config = small(manifest.data("configs", cell["config"]))
    traffic = quick(manifest.data("traffic", cell["traffic"]))
    got = calibrate.readings(bench, cell, [5, 6], 1, SECONDS, "cpu",
                             config=config, traffic=traffic,
                             emit=lambda line: None)
    limits = manifest.data("limits", MG)
    for n, limit in limits.items():
        assert got["lower"][n] <= limit, n
        if n != "pcg_iters_off":    # an exact count; the control runs none
            assert got["upper"][n] > limit, n


@pytest.mark.parametrize("metric", ["setup.mg_s", "mg.vcycle_ms"])
def test_without_the_recorder_the_new_readers_give_none(monkeypatch, metric):
    monkeypatch.setattr(program, "RECORDER", "portbench.record")
    assert manifest.module("metrics", metric).read(None) is None
