"""BENCHMARK.json against the contract's shape, and discovery by name."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark import spec
from benchmark.tests import tiny

DOC = spec.load_spec()
NAME, UNIT = spec.NAME_RE, spec.UNIT_RE
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(DOC) == TOP
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in DOC[section]]
    assert len(names) == len(set(names))
    for e in DOC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_entries_have_only_their_keys():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in DOC["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(DOC, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(DOC, w["name"])
        for m in spec.per_layer(DOC, w["name"]):
            assert m["moves"] in e2e


@pytest.mark.parametrize("w", [w["name"] for w in DOC["workloads"]])
def test_cell_files_found_by_name(w):
    cell = spec.cell(DOC, w)
    cfg = spec.load_config(DOC, cell["config"])
    assert {"ini", "program", "room", "image", "judge", "limits"} <= set(cfg)
    assert spec.load_traffic(cell["traffic"])["kind"] in ("query", "track")
    for m in spec.per_layer(DOC, w):
        assert callable(spec.reader(m["name"]))


def test_added_files_are_found_without_edits(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as files
    and entries in a copy, are found and read with no edit of a file that
    was there."""
    root = tiny.make(tmp_path)
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*.py")}
    cfg = json.loads((bench / "configs" / "omniscenes.json").read_text())
    cfg["name"] = "omniscenes-wide"
    (bench / "configs" / "omniscenes-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "query-2clients.json").read_text())
    mix["clients"] = 3
    (bench / "traffic" / "query-3clients.json").write_text(json.dumps(mix))
    (bench / "metrics" / "service.requests.query.py").write_text(
        "def read(ctx):\n    return float(len(ctx['records']))\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(name="omniscenes-wide", source="x",
                               file="benchmark/configs/omniscenes-wide.json",
                               reduced=[], why="x"))
    doc["workloads"].append(dict(name="omniscenes-wide.q3",
                                 config="omniscenes-wide",
                                 traffic="query-3clients", chips=1, why="x"))
    for m in doc["end_to_end"]:
        if "workloads" in m and "omniscenes.query" in m["workloads"]:
            m["workloads"].append("omniscenes-wide.q3")
    doc["per_layer"].append(dict(
        name="service.requests.query", unit="requests", better="higher",
        source="program_counter", layer="service", moves="queries_per_s",
        workloads=["omniscenes-wide.q3"]))
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    res = tiny.run(root, "omniscenes-wide.q3", 3, trace=True)
    assert res["metrics"]["service.requests.query"]["value"] == \
        res["attempted"]
    assert {p: p.read_bytes() for p in before} == before
    shutil.rmtree(root)
