"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, bounds and run length."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert len(M["command"]) <= 32


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"]
                         + M["end_to_end"] + M["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:
        texts.append(entry["source"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_unique_names():
    for group in (M["configs"], M["workloads"],
                  M["end_to_end"] + M["per_layer"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_each_cell_finds_its_files_and_reports_enough():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    configs = {c["name"]: c for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        importlib.import_module(f"perfbench.drivers.{cfg['driver']}")
        assert (ROOT / "perfbench" / "traffic" /
                f"{w['traffic']}.json").is_file()
        mine = [m for m in M["per_layer"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert mine
        moved = {m["moves"] for m in mine}
        reported = {m["name"] for m in M["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert moved <= reported and len(reported - {"setup_s"}) >= 1
    for m in M["per_layer"]:
        importlib.import_module(f"perfbench.metrics.{m['name']}")
        assert m["moves"] in e2e
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(k) <= 200 for k in layers)


def test_every_config_is_used_and_files_under_paths():
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
