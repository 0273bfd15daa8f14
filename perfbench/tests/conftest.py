import copy
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cpu_pin():
    """Runs the port's plain versions on the CPU for the test."""
    from repro_torch.torchgm import frontier
    saved = frontier.DEFAULT_DEVICE
    frontier.DEFAULT_DEVICE = "cpu"
    yield
    frontier.DEFAULT_DEVICE = saved


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def tiny_cell(name: str):
    """The cell at a size a CPU test run holds: the graph at 1% of the
    profile (what the configuration states of the whole one dropped),
    top_k 256, small pools."""
    from perfbench import bench
    from perfbench.drivers.common import STATED
    cell = bench.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    g = cell.config["graph"]
    for k in STATED:
        g.pop(k, None)
    g["scale"] = 0.01
    cell.config["filter"]["top_k"] = 256
    cell.traffic = dict(cell.traffic, pool=40, warmup=cell.traffic[
        "outstanding"])
    return cell
