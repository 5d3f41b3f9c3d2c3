"""BENCHMARK.json against the benchmark's contract: its keys, the
characters of every name and unit, the files each entry names, the bounds,
and what every cell reports."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.tests.tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head)|(_dim|_rank)$|expansion|experts_per_tok")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(line(w) and not w.startswith("/") for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and not any(WIDTHS.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_workloads_name_their_files():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "entries" / f"{traffic['entry']}.py").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        metrics = ROOT / "benchmark" / "metrics"
        assert (metrics / f"{m['name']}.py").is_file() or (metrics / f"{m['name'].split('.')[0]}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_enough(cell):
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m["name"] for m in SPEC["end_to_end"] if applies(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(applies(m) for m in SPEC["per_layer"])
