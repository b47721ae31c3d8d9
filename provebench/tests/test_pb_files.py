"""BENCHMARK.json and the files it names: every name is found, and every
cell reports what its metrics say."""

import json
import os

import pytest

import harness

ROOT = os.path.dirname(harness.HERE)


def test_paths_and_command(bench):
    assert bench["paths"] == ["provebench"]
    assert bench["command"] == ["python3", "provebench/run.py"]


def test_the_committed_file_keeps_every_name_distinct_and_used():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[key]]
        assert len(names) == len(set(names))
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_config_file_is_found_and_states_its_source(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"provebench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert os.path.isfile(os.path.join(harness.HERE, "backends", f"{cfg['backend']}.py"))


def test_every_cell_loads_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness._load_module("metrics", m["name"])
        assert callable(mod.read)


def test_unknown_cell_raises(bench):
    with pytest.raises(KeyError):
        harness.load_cell(bench, "no-such-cell")


def test_a_metric_without_workloads_follows_what_it_moves(bench):
    extra = dict(bench)
    extra["end_to_end"] = bench["end_to_end"] + [
        {"name": "other_rate", "unit": "steps/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": ["other.t20"]}]
    extra["workloads"] = bench["workloads"] + [
        {"name": "other.t20", "config": "stark-v1", "traffic": "t20", "chips": 1, "why": "x"}]
    extra["per_layer"] = bench["per_layer"] + [
        {"name": "lde_s.stark", "unit": "s", "better": "lower", "source": "program_span",
         "layer": "LDE", "moves": "other_rate"}]
    names = [m["name"] for m in harness.load_cell(extra, "other.t20").per_layer]
    assert names == ["lde_s.stark"]
    names = [m["name"] for m in harness.load_cell(extra, "stark-v1.t20").per_layer]
    assert names.count("lde_s.stark") == 1


def test_the_committed_file_keeps_the_contract_limits():
    import re

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert "bound" not in m and line(m["layer"])
    assert len(json.dumps(b)) <= 64 * 1024
