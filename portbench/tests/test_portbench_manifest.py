"""BENCHMARK.json against the contract, and the files it names."""

import json
import re

import pytest

from portbench import manifest

CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_tok")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert any(w.startswith(bench["paths"][0] + "/") for w in cmd)
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits the driver's 43,200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(bench):
    manifest.validate(bench)
    for group in ("configs", "workloads"):
        for x in bench[group]:
            for key in ("why",) + (("source",) if group == "configs" else ()):
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] \
                    and "\t" not in x[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) <= E2E_KEYS and set(m) >= E2E_KEYS - {"workloads"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= LAYER_KEYS and set(m) >= LAYER_KEYS - {"workloads"}
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_configs_are_files_of_their_own(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        data = manifest.data("configs", c["name"])
        assert data["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert key in data and not WIDTHS.search(key)
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_every_cell_finds_its_files(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = manifest.data("traffic", w["traffic"])
        entry = manifest.module("entries", traffic["entry"]).ENTRY
        limits = manifest.data("limits", w["name"])
        assert set(limits) == set(entry.checks)


def test_every_cell_reports_what_its_metrics_move(bench):
    names = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(manifest.module("metrics", m["name"]), "read")
    for w in names:
        e2e = manifest.metrics_of(bench, w, traced=False)
        assert any(m["name"] == "setup_s" for m in e2e)
        assert len(e2e) >= 2
        assert manifest.metrics_of(bench, w, traced=True)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", names)
    assert all(layer.strip() == layer for layer in layers)


def test_four_chip_cells_within_their_share(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)


def test_trace_reduction():
    from portbench import trace

    # Device busy 0-10 and 15-20 us (overlapping ops merged); the host is in
    # "sync" from 10 to 14 and in "launch" from 14 to 20.
    dev = [(0, 6, "k1"), (4, 10, "k2"), (15, 20, "k1")]
    host = [(0, 20, trace.REQUEST), (10, 14, "sync"), (14, 20, "launch")]
    got = trace.reduce(dev, host, 0.0, 20.0, 2)
    assert got["busy_s"] == pytest.approx(15e-6)
    assert got["window_s"] == pytest.approx(20e-6)
    assert got["device_ops"] == 3
    assert dict(got["device_op_s"]) == pytest.approx({"k1": 11e-6,
                                                      "k2": 6e-6})
    assert dict(got["idle_gaps"]) == pytest.approx({"sync": 5e-6})
