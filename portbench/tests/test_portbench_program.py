"""The per-layer metrics read from the program's own recorder
(``portbench/program.py``): traced runs at 16³ on the CPU read them, and a
program without the recorder gives None for each, never raising."""

import pytest

from conftest import quick, small
from portbench import manifest, program, run

SECONDS = 0.2
FROM_PROGRAM = {
    "hpcg-104.pcg50": ("pcg.host_reads", "setup.pcg_analyze_s",
                       "setup.pcg_schedules_s"),
    "hpcg-104.spmm-n32": ("spmm.dispatch_ms", "setup.spmm_formats_s"),
}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _traced(bench, name):
    cell = manifest.cell(bench, name)
    config = small(manifest.data("configs", cell["config"]))
    traffic = quick(manifest.data("traffic", cell["traffic"]))
    result, _ = run.run_cell(bench, cell, 2 ** 31 + 23, SECONDS, True, "cpu",
                             config=config, traffic=traffic,
                             since_start=lambda: 1.0)
    return result


@pytest.mark.parametrize("name", sorted(FROM_PROGRAM))
def test_traced_runs_read_the_recorder(bench, name):
    result = _traced(bench, name)
    assert result["correct"] is True
    got = result["metrics"]
    for metric in FROM_PROGRAM[name]:
        assert got[metric]["value"] > 0, metric
    if name == "hpcg-104.pcg50":
        # the eager loop on the CPU: a test a turn until max_iters, and the
        # residual's float
        iters = int(manifest.data("traffic", "pcg50")["iters"])
        assert got["pcg.host_reads"]["value"] == iters + 1
        # no graphs on the CPU: nothing to read
        assert "graphs.nodes.pcg" not in got
        assert "graphs.node_us.pcg" not in got
    else:
        assert got["spmm.dispatch_ms"]["value"] <= got["spmm.host_ms"][
            "value"] or "spmm.host_ms" not in got


def test_without_the_recorder_every_reader_gives_none(bench, monkeypatch):
    monkeypatch.setattr(program, "RECORDER", "portbench.record")
    names = [m["name"] for m in bench["per_layer"]
             if m["source"] == "program_span"
             and m["name"] not in ("setup.order_s", "setup.analyze_s")]
    assert len(names) == 9
    for name in names:
        assert manifest.module("metrics", name).read(None) is None, name
