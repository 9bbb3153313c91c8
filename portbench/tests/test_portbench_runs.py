"""Whole runs on the CPU at 16³: the result line's keys, the control that
has to fail, planted faults that have to read as not correct, and no JAX in
the process."""

import ast
import importlib
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, quick, small
from portbench import calibrate, manifest, run

RESULT = {"correct", "attempted", "failed", "metrics", "device", "checks"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}
SECONDS = 0.2


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _run(bench, name, traced=False, seed=2 ** 31 + 11):
    cell = manifest.cell(bench, name)
    config = small(manifest.data("configs", cell["config"]))
    traffic = quick(manifest.data("traffic", cell["traffic"]))
    return run.run_cell(bench, cell, seed, SECONDS, traced, "cpu",
                        config=config, traffic=traffic,
                        since_start=lambda: 1.0)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(bench, traced):
    for w in bench["workloads"]:
        result, lines = _run(bench, w["name"], traced)
        want = RESULT | ({"breakdown"} if traced else set())
        assert set(result) == want and list(result)[-1] == "checks"
        assert result["correct"] is True and result["failed"] == 0
        assert result["attempted"] >= 1
        assert set(result["device"]) == DEVICE | (
            {"busy_s", "window_s"} if traced else set())
        names = {m["name"] for m in manifest.metrics_of(bench, w["name"],
                                                        traced)}
        # Device readings need the card; on the CPU they are left out.
        assert set(result["metrics"]) <= names
        if not traced:
            assert set(result["metrics"]) == names
        for m in result["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0
        json.dumps(result)
        limits = manifest.data("limits", w["name"])
        assert set(result["checks"]) == set(limits)
        assert all(f"check {n} " in line
                   for n, line in zip(limits, lines[-len(limits):]))


def test_the_control_fails_and_the_program_passes(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        config = small(manifest.data("configs", cell["config"]))
        got = calibrate.readings(bench, cell, [5, 6], 1, SECONDS, "cpu",
                                 config=config, emit=lambda line: None)
        limits = manifest.data("limits", w["name"])
        first = next(iter(limits))
        assert got["upper"][first] > limits[first], w["name"]
        assert all(got["lower"][n] <= limits[n] for n in limits), w["name"]


def _altered(out):
    out = out[0] if isinstance(out, tuple) else out
    out.view(-1)[0] += 1.0


FAULTS = {
    "an answer altered where it is produced": {
        "hpcg-104.spmm-n256": ("models.operator", "SparseOperator.matmul",
                               lambda f: lambda self, b: _alter(f(self, b))),
        "hpcg-32.solve-1rhs": ("models.operator", "SparseOperator.solve",
                               lambda f: lambda self, b: _alter(f(self, b))),
        "hpcg-104.pcg50": ("models.operator", "SparseOperator.solve_cg",
                           lambda f: lambda self, b, **k:
                           _alter(f(self, b, **k))),
    },
    "half of the batch left out": {
        "hpcg-104.spmm-n32": ("models.operator", "SparseOperator.matmul",
                              lambda f: lambda self, b: _half(f(self, b))),
    },
    "a step that returns its state unchanged": {
        "hpcg-32.solve-1rhs": ("models.sparse_triangular",
                               "solve_triangular_sparse",
                               lambda f: lambda l, b, *a, **k: b.clone()),
        "hpcg-104.pcg50": ("models.pcg", "_pcg_step",
                           lambda f: lambda setup, x, r, p, rz:
                           (x, r, p, rz)),
    },
}


def _alter(out):
    _altered(out)
    return out


def _half(out):
    out[:, out.shape[1] // 2:] = 0
    return out


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_read_not_correct(bench, monkeypatch, fault):
    for name, (mod, attr, make) in FAULTS[fault].items():
        module = importlib.import_module(
            f"basic_sparse_matrix_tpu_torch.{mod}")
        owner, leaf = module, attr
        if "." in attr:
            cls, leaf = attr.split(".")
            owner = getattr(module, cls)
        with monkeypatch.context() as m:
            m.setattr(owner, leaf, make(getattr(owner, leaf)))
            result, _ = _run(bench, name)
        assert result["correct"] is False, (fault, name)
        assert result["failed"] >= 1


def test_no_jax_in_the_process():
    code = (
        "import json, sys\n"
        "from portbench import manifest, run\n"
        "from conftest import quick, small\n"
        "b = manifest.load()\n"
        "for w in b['workloads']:\n"
        "    c = manifest.cell(b, w['name'])\n"
        "    cfg = small(manifest.data('configs', c['config']))\n"
        "    tr = quick(manifest.data('traffic', c['traffic']))\n"
        "    run.run_cell(b, c, 7, 0.1, False, 'cpu', config=cfg,\n"
        "                 traffic=tr)\n"
        "print(json.dumps(run.foreign_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT}/portbench/tests",
                              "PATH": "/usr/bin:/bin"}, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        found = set(_imports(path))
        assert not found & {"jax", "jaxlib", "flax",
                            "basic_sparse_matrix_tpu"}, path
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "basic_sparse_matrix_tpu_torch" not in set(_imports(path))
        assert "basic_sparse_matrix_tpu_torch" not in path.read_text()


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "hpcg-104.spmm-n256", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hpcg-32.solve-1rhs", "--seed", "2147483659", "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
