"""The harness finds every cell's parts by name, and BENCHMARK.json keeps
to the benchmark's contract."""

import json
import re

import pytest

from portbench import spec
from portbench.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = spec.cell(BENCH, name)
    cfg = spec.config(BENCH, ROOT, cell["config"])
    fam = spec.family(cfg["family"])
    spec.reference(fam.REFERENCE)
    tr = spec.traffic(cell["traffic"])
    spec.driver(tr["driver"])
    assert set(spec.limits(name))
    e2e = {m["name"] for m in spec.metrics_for(BENCH, name, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.metrics_for(BENCH, name, "per_layer")
    assert layers
    for m in layers:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e


def test_every_reader_has_an_entry_and_back():
    files = {p.name[:-3] for p in (spec.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = spec.config(BENCH, ROOT, c["name"])
        assert cfg["source"] == c["source"]
        # every key changed from the published config is listed
        assert sorted(k for k in cfg["published"] if k != "file") == \
            sorted(c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
