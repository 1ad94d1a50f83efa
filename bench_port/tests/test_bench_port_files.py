"""BENCHMARK.json and the benchmark's files against the rules they are
written to: names, units, limits, and every name found as a file."""

import json
import re

import pytest

from bench_port_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
DIR = ROOT / "bench_port"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHARS = re.compile(r"^[A-Za-z0-9_./-]+$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most \
        and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"][1].startswith("bench_port/")
    assert all(line(w) for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] \
        + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert all(m["source"] in SOURCES for m in METRICS)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"bench_port/configs/{c['name']}.json"
        assert line(c["source"]) and line(c["why"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["source"].startswith("https://")


def test_cells():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert four <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line(w["why"])
        assert (DIR / "traffic" / f"{w['traffic']}.py").is_file()


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for m in METRICS:
        assert (DIR / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_reports(cell):
    """setup_s, another end-to-end metric and a per-layer one a cell."""
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("path", sorted(
    p.name for p in (DIR / "workloads").glob("*.json")))
def test_workload_file(path):
    w = json.loads((DIR / "workloads" / path).read_text())
    entry = [c for c in BENCH["workloads"] if c["name"] == w["name"]]
    assert path == f"{w['name']}.json" and entry
    for key in ("config", "traffic", "chips", "why"):
        assert w[key] == entry[0][key]
    assert line(w["who"]) and isinstance(w["params"], dict)
    assert all(v >= 0 for v in w["limits"].values())


@pytest.mark.parametrize("path", sorted(
    p.name for p in (DIR / "configs").glob("*.json")))
def test_config_file(path):
    c = json.loads((DIR / "configs" / path).read_text())
    assert path == f"{c['name']}.json" and NAME.match(c["name"])
    assert c["decode_type"] in ("SOFT16", "SOFT8", "HARD8")
    assert c["arith"] in ("saturating", "wrapping")
    assert c["symbol_dtype"] in ("int8", "int16", "int32")
    assert all(NAME.match(k) for k in c["reduced"])
    assert all(g & 1 and g >> (c["K"] - 1) & 1 for g in c["G"])


def test_file_names():
    files = [p.relative_to(ROOT) for p in DIR.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    assert files and all(CHARS.match(str(p)) for p in files)
