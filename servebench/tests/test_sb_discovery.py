"""Every configuration, mix and metric that BENCHMARK.json names is a file
found by its name, and a new one is found the same way: a later change
adds files and entries and edits none."""
import json

import pytest

from servebench import harness
from servebench.traffic import gen

BENCH = harness.load_bench()
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(harness.load_reader(name).read)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_each_cell_resolves(cell):
    c = harness.cell_of(BENCH, cell)
    cfg = harness.load_config(c["config"])
    mix = gen.load_mix(c["traffic"])
    assert cfg["name"] == c["config"]
    assert mix["loop"] in ("open", "closed")
    entry = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert entry["file"] == f"servebench/configs/{c['config']}.json"
    assert entry["reduced"] == cfg["reduced"]
    assert entry["source"] == cfg["source"]
    kinds = {m["name"] for m in harness.metrics_for(BENCH, cell,
                                                    "end_to_end")}
    assert "setup_s" in kinds and len(kinds) >= 2
    assert harness.metrics_for(BENCH, cell, "per_layer")


def test_every_per_layer_metric_names_a_cell_and_its_end_to_end_metric():
    cells = {c["name"] for c in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs").mkdir()
    (tmp_path / "metrics" / "new.layer_ms.py").write_text(
        "def read(rec):\n    return rec['x'] * 2\n")
    (tmp_path / "configs" / "new-model.json").write_text(
        json.dumps({"name": "new-model"}))
    (tmp_path / "new-mix.json").write_text(json.dumps({"loop": "open"}))
    monkeypatch.setattr(harness, "HERE", tmp_path)
    monkeypatch.setattr(gen, "TRAFFIC_DIR", tmp_path)
    assert harness.load_reader("new.layer_ms").read({"x": 2}) == 4
    assert harness.load_config("new-model")["name"] == "new-model"
    assert gen.load_mix("new-mix")["loop"] == "open"
    bench = {"workloads": [{"name": "m.new", "config": "new-model",
                            "traffic": "new-mix", "chips": 1}],
             "per_layer": [{"name": "new.layer_ms", "workloads": ["m.new"]},
                           {"name": "other", "workloads": ["x"]}],
             "end_to_end": [{"name": "setup_s"}]}
    assert [m["name"] for m in harness.metrics_for(bench, "m.new",
                                                   "per_layer")] == \
        ["new.layer_ms"]
    with pytest.raises(FileNotFoundError):
        harness.load_reader("missing")
