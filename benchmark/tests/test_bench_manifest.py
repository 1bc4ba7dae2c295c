"""BENCHMARK.json against the contract's shape, and every cell's files
found by name; a cell added as files and a manifest entry is picked up
with no file of the harness edited."""
import importlib
import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_shape():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"][1] == "benchmark/run.py"
    assert 1 <= m["run_seconds"] <= 51
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[part]]
    assert len(names) == len(set(names))
    for part in ("end_to_end", "per_layer"):
        for x in m[part]:
            assert NAME.match(x["name"]) and UNIT.match(x["unit"])
            assert x["better"] in ("lower", "higher")
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["moves"] in e2e
        assert all(c in e2e[x["moves"]].get("workloads", [c]) for c in x["workloads"])
    for c in m["configs"]:
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("benchmark/configs/")
    for w in m["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.find(cell)
    entry = importlib.import_module("benchmark.entries." + c.traffic["entry"])
    assert hasattr(entry, "Entry")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_new_cell_is_picked_up(tmp_path):
    """A cell added with its own traffic and cell files, and an entry in
    the manifest: found with no harness file edited."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    m["workloads"].append({"name": "infer.b32", "config": "smirk_train",
                           "traffic": "infer_calls.b32", "chips": 1, "why": "a test cell"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "infer.b64" in x.get("workloads", []):
            x["workloads"].append("infer.b32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    traffic = json.loads((tmp_path / "benchmark/traffic/infer_calls.b64.json").read_text())
    (tmp_path / "benchmark/traffic/infer_calls.b32.json").write_text(
        json.dumps(dict(traffic, batch=32)))
    (tmp_path / "benchmark/workloads/infer.b32.json").write_text(
        (tmp_path / "benchmark/workloads/infer.b64.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*.py")}
    c = harness.find("infer.b32", root=str(tmp_path))
    assert c.traffic["batch"] == 32 and c.cfg["name"] == "smirk_train"
    assert {m["name"] for m in c.end_to_end} == {"serve_images_per_s", "serve_p95_ms", "setup_s"}
    assert {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*.py")} == before
