"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
their configurations and the metrics; everything else is a file found by
its name under this package:

* a configuration: the ``file`` its ``configs`` entry names
  (``configs/<name>.json``);
* a traffic mix: ``traffic/<name>.json`` (traffic.py reads it);
* a cell's correctness limits: ``limits/<cell>.json``;
* a metric's reader: ``metrics/<name>.py``, whose ``read(run)`` returns
  the metric's value, or None where the run has nothing to read;
* a scene generator other than scene.py's own: ``scenes/<generator>.py``,
  whose ``generate(scene)`` returns the triangles (scene.py).

A later cell, configuration, mix or metric is a new file and a new entry;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]   # the metrics entries this cell reports, in order
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set[str] | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    configuration, mix, limits and metrics; raises KeyError naming what is
    missing."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    pkg = root / PACKAGE.name
    traffic = load_json(pkg / "traffic" / f"{w['traffic']}.json")
    limits = load_json(pkg / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def module(folder: str, name: str, root: Path = ROOT):
    """The module of ``<folder>/<name>.py`` under this package in the
    checkout ``root``; raises KeyError naming the missing file."""
    path = root / PACKAGE.name / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    if spec is None or not path.exists():
        raise KeyError(f"no file {path} for {name!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return module("metrics", metric, root).read


def read_metrics(entries: list[dict], run) -> dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something in ``run``."""
    out = {}
    for m in entries:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
