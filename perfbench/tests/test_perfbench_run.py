"""One run end to end on the CPU pin, and what a run refuses."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import bench

from .conftest import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


CELL = "epinions_filter.hybrid"


@pytest.mark.parametrize("trace,seed", [(False, 2 ** 31 + 17), (False, 7),
                                        (True, 2 ** 40 + 3)])
def test_cell_runs_end_to_end(trace, seed, cpu_pin):
    import time
    cell = tiny_cell(CELL)
    out = bench.run_cell(cell, seed=seed, seconds=1.0, trace=trace,
                         t_start=time.perf_counter())
    line = json.loads(json.dumps(out))
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torchish", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert bench.forbidden_modules() == ["repro.core"]


def test_nothing_perfbench_imports_loads_jax_or_repro(tmp_path):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import perfbench.run, perfbench.bench, perfbench.trace\n"
            "import perfbench.drivers.serve_step\n"
            "import perfbench.reference.simulation\n"
            "import pkgutil, importlib, perfbench.metrics as m\n"
            "[importlib.import_module('perfbench.metrics.' + x.name) "
            "for x in pkgutil.iter_modules(m.__path__)]\n"
            "from perfbench import bench\n"
            "print(bench.forbidden_modules())\n"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_port():
    for f in (ROOT / "perfbench" / "reference").glob("*.py"):
        text = f.read_text()
        assert "repro_torch" not in text and "import jax" not in text
        assert "from repro" not in text and "import repro" not in text


def test_refuses_without_a_card_and_without_the_port(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, "-m", "perfbench.run", "--workload",
            CELL, "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    out = subprocess.run(args, capture_output=True, text=True, cwd=ROOT,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    out = subprocess.run(args, capture_output=True, text=True, cwd=tmp_path,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_the_data_set_is_what_the_configuration_states():
    from perfbench.drivers import common
    from perfbench.gen.graphs import paper_profile_graph
    cfg = bench.load_cell(CELL).config
    g = cfg["graph"]
    base = paper_profile_graph(g["profile"], scale=g["scale"], seed=g["seed"])
    assert common.graph_facts(base) == {k: g[k] for k in common.STATED}
    wrong = dict(cfg, graph=dict(g, scale=0.01))
    with pytest.raises(ValueError, match="not what the configuration"):
        common.make_graph(wrong, 1)
