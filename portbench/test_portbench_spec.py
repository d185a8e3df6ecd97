"""Finding a cell's configuration, mix, limits and metric readers by name,
and a cell added as new files only (run: python -m pytest portbench -q)."""

import json
import shutil

import pytest

from portbench import spec


def test_every_cell_resolves_with_readers():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["request"] in ("frame", "progressive")
        assert cell.limits and cell.chips == w["chips"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        moved = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in moved for m in cell.per_layer)


def test_unknown_cell_and_metric_raise():
    with pytest.raises(KeyError):
        spec.find_cell("no.such_cell")
    with pytest.raises(KeyError):
        spec.reader("no_such_metric")


def test_a_cell_added_as_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.PACKAGE, root / "portbench")
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    pkg = root / "portbench"
    config = json.loads((pkg / "configs" / "bunny69k.json").read_text())
    config.update(name="sphere10k")
    config["scene"]["target_tris"] = 10000
    (pkg / "configs" / "sphere10k.json").write_text(json.dumps(config))
    (pkg / "traffic" / "glance.json").write_text(json.dumps(
        dict(spec.load_json(pkg / "traffic" / "interactive.json"), width=256, height=256)))
    (pkg / "limits" / "sphere10k.glance.json").write_text(json.dumps({"mean_err": 1e-3}))
    (pkg / "metrics" / "requests_done.py").write_text("def read(run):\n    return run.requests\n")
    bench["configs"].append({"name": "sphere10k", "source": "test", "file": "portbench/configs/sphere10k.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "sphere10k.glance", "config": "sphere10k", "traffic": "glance",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "frame_ms_mean",
                               "workloads": ["sphere10k.glance"]})
    cell = spec.find_cell("sphere10k.glance", bench, root)
    assert cell.config["scene"]["target_tris"] == 10000 and cell.traffic["width"] == 256
    assert [m["name"] for m in cell.per_layer][-1] == "requests_done"

    class Run:
        requests = 7

    assert spec.reader("requests_done", root)(Run()) == 7
