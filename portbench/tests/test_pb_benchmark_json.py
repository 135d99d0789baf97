"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""
import json
import re

from portbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()


def test_every_name_and_unit_uses_only_the_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metrics_name_their_layer_and_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_finds_its_file():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((ROOT / "portbench/checks" / f"{w['name']}.json").read_text())
        assert limits["limits"]
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name'].split('.')[0]}.py").is_file()
    for mix in {w["traffic"] for w in BENCH["workloads"]}:
        entry = json.loads((ROOT / "portbench/traffic" / f"{mix}.json").read_text())["entry"]
        assert (ROOT / "portbench/entries" / f"{entry}.py").is_file()
    assert all(any(w["config"] == c for w in BENCH["workloads"]) for c in configs)


def test_the_file_is_small():
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
