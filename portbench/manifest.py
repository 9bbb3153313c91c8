"""``BENCHMARK.json`` and the files it names, found by name under
``portbench/``:

* a configuration ``<config>`` in ``configs/<config>.json``;
* a traffic mix ``<traffic>`` in ``traffic/<traffic>.json``, whose
  ``entry`` names the program entry it drives, ``entries/<entry>.py``;
* a metric ``<name>`` (end-to-end or per-layer) in ``metrics/<name>.py``,
  a reader ``read(record)`` that returns a number or None;
* the limits of a cell's compared numbers in ``limits/<cell>.json``.

A cell or metric is added by adding such files and entries, without
editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        bench = json.load(f)
    validate(bench)
    return bench


def validate(bench: dict) -> None:
    """Names and units in the characters the contract allows, no name
    twice, and every cell's configuration declared."""
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    bad = [n for n in names if not NAME.fullmatch(n)]
    if bad:
        raise ValueError(f"names outside the allowed characters: {bad}")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in bench[group]]
        if len(seen) != len(set(seen)):
            raise ValueError(f"a name appears twice in {group}")
    seen = [m["name"] for m in metrics]
    if len(seen) != len(set(seen)):
        raise ValueError("a metric name appears twice")
    bad = [m["unit"] for m in metrics if not UNIT.fullmatch(m["unit"])]
    if bad:
        raise ValueError(f"units outside the allowed characters: {bad}")
    configs = set(c["name"] for c in bench["configs"])
    missing = [w["name"] for w in bench["workloads"]
               if w["config"] not in configs]
    if missing:
        raise ValueError(f"cells with an undeclared configuration: {missing}")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's per-layer metrics (traced) or end-to-end metrics."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def data(kind: str, name: str) -> dict:
    """``configs``, ``traffic`` or ``limits`` file ``name``."""
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str) -> ModuleType:
    """``entries`` or ``metrics`` module ``name``, loaded from its file."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
