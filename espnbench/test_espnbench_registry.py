"""The benchmark's registry: every cell, configuration, traffic mix and
per-layer metric is found by name, and a new file is picked up with no
edit; BENCHMARK.json keeps the contract's shape."""
import json
import re
from pathlib import Path

import pytest

from espnbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = harness.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(cfg):
    c = harness.load_config(cfg["name"])
    assert c["name"] == cfg["name"]
    assert cfg["file"] == f"espnbench/configs/{cfg['name']}.json"
    assert set(cfg["reduced"]) <= set(c["reduced"])
    assert set(c["limits"]) >= {"cell_mismatch", "assign_gap", "miss_gap",
                                "score_gap", "rank_gap"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(cell):
    harness.load_config(cell["config"])
    t = harness.load_traffic(cell["traffic"])
    assert t["loop"] in ("closed", "open")
    for m in harness.per_layer_of(BENCH, cell["name"]):
        assert callable(harness.load_metric(m["name"]))
    e2e = {m["name"] for m in harness.end_to_end_of(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_of(BENCH, cell["name"])
    assert layer
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [
    {"name": p.name[:-3]} for p in sorted((ROOT / "espnbench" / "metrics")
                                          .glob("*.py"))],
    ids=lambda m: m["name"])
def test_metric_reader_reads_nothing_from_an_empty_record(metric):
    from espnbench.probe import Probe
    from espnbench.loops import Window
    record = {"probe": Probe(), "trace": {}, "window": Window(),
              "traffic": {"loop": "closed"}, "flops": 0.0,
              "config": harness.load_config("espn-colberter-1m")}
    assert harness.load_metric(metric["name"])(record) is None


def test_new_files_are_picked_up_with_no_edit(tmp_path):
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    cfg = harness.load_config("espn-colberter-1m")
    cfg["name"] = "new-config"
    (tmp_path / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps(
        dict(harness.load_traffic("batch64-uniform"), batch=8)))
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(record):\n    return record['n'] * 2\n")
    assert harness.load_config("new-config", tmp_path)["name"] == \
        "new-config"
    assert harness.load_traffic("new-mix", tmp_path)["batch"] == 8
    assert harness.load_metric("new_metric.x", tmp_path)({"n": 3}) == 6
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "new.cell", "config": "new-config", "traffic": "new-mix",
         "chips": 1, "why": "x"}],
        per_layer=BENCH["per_layer"] + [
            {"name": "new_metric.x", "unit": "%", "better": "higher",
             "source": "program_counter", "layer": "x", "moves": "qps",
             "workloads": ["new.cell"]}])
    assert [m["name"] for m in harness.per_layer_of(bench, "new.cell")] == \
        ["new_metric.x"]
    with pytest.raises(KeyError):
        harness.load_config("no-such-config", tmp_path)


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["espnbench"] and len(b["command"]) <= 32
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits in its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == \
        len(names)
    cfgs = {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    assert cfgs == {w["config"] for w in b["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200
               for w in b["workloads"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", ())) <= cells
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_metric_named_has_a_reader_and_every_reader_a_file():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "espnbench" / "metrics").glob("*.py")}
    assert names <= files
