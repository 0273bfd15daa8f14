"""The port stands alone: it imports neither JAX nor the reference package.

The card's machine has no JAX, so ``repro_torch`` and ``chip_smoke.py``
must never reach ``jax`` or ``repro``: checked statically over every
source file, and dynamically by running the slice in a fresh process.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _sources():
    yield ROOT / "chip_smoke.py"
    yield from sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_slice_runs_without_jax_or_reference_modules():
    code = """
import sys
from repro_torch.torchgm import frontier
frontier.DEFAULT_DEVICE = "cpu"
from repro_torch.core import GM, GMOptions, ENUM_METHODS
import repro_torch.core.baselines, repro_torch.launch.mesh
import repro_torch.torchgm.distributed
import repro_torch.models.transformer, repro_torch.train, repro_torch.configs
import repro_torch.launch.train
from repro_torch.configs import get_config
lm = get_config("qwen2-7b").smoke(seed=0, device="cpu")
assert lm["finite"], lm
import repro_torch.models.gnn, repro_torch.models.recsys
import repro_torch.data.sampler, repro_torch.data.gnn_data
import repro_torch.data.recsys_data
gnn = get_config("graphsage-reddit").smoke(seed=0, device="cpu")
assert gnn["finite"], gnn
import repro_torch.models.gnn_dist, repro_torch.configs.pattern
pattern = get_config("rig_gm").smoke(seed=0, device="cpu")
assert pattern["finite"], pattern
import repro_torch.dist, repro_torch.dist.sharding, repro_torch.dist.meta
import repro_torch.launch.dryrun, repro_torch.launch.hillclimb
from repro_torch.launch.dryrun import fake_group, trace
from repro_torch.launch.mesh import make_local_mesh
with fake_group(4):
    unit = get_config("rig_gm").build_dryrun(
        dict(kind="closure", n_pad=1024), make_local_mesh(2, 2))
    assert trace(unit)["flops"] > 0
from repro_torch.data.graphs import random_labeled_graph
from repro_torch.data.queries import random_query_from_graph
g = random_labeled_graph(50, avg_degree=2.5, n_labels=3, seed=1)
q = random_query_from_graph(g, n_nodes=4, qtype="H", seed=2)
counts = {GM(g).match(q, GMOptions(enum_method=m, limit=None)).count
          for m in ENUM_METHODS}
assert len(counts) == 1, counts
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_serve_path_runs_without_jax_or_reference_modules():
    """The serving path (server, engine, whole-graph matcher, bitmm) on
    the CPU pin, then ``python -m repro_torch.launch.serve --help``."""
    code = """
import runpy, sys
from repro_torch.torchgm import frontier
frontier.DEFAULT_DEVICE = "cpu"
from repro_torch.data.graphs import random_labeled_graph
from repro_torch.data.queries import random_query_from_graph
from repro_torch.launch.serve import QueryServer
g = random_labeled_graph(200, avg_degree=3.0, n_labels=4, seed=1)
server = QueryServer(g, batch_size=4, capacity=512)
for i in range(4):
    server.submit(i, random_query_from_graph(g, 3 + i % 3, qtype="CHD"[i % 3],
                                             seed=i))
server.drain()
assert all(r.status == "done" for r in server.journal.values())
assert any(r.backend == "device" for r in server.journal.values())
sys.argv = ["serve", "--help"]
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
    assert "LEAKED []" in out.stdout, out.stdout


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
