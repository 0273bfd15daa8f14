"""The served cell's control comes out as not correct, at the cell's own
size on the card (``-m cuda``), on three seeds: the program with the last
page of each paged MJoin level dropped (the cut a PR that loses a page of
a level would make).  Each seed is one untraced run of the cell as the
benchmark makes it, a window of ``run_seconds`` and the cell's own check.
It prints its readings (the checks beside their limits), which PERF.md
records."""

import json
import time

import pytest

from perfbench import bench

SEEDS = [2 ** 31 + 111, 2 ** 31 + 222, 2 ** 31 + 333]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_control_last_page_dropped(seed, cuda, monkeypatch):
    from repro_torch.torchgm import enumerate as penum
    cut = penum._cut
    monkeypatch.setattr(penum, "_cut", lambda incl, cap: cut(incl, cap)[:-1])
    seconds = json.loads((bench.ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    line = bench.run_cell(bench.load_cell("epinions_serve.hybrid"),
                          seed=seed, seconds=seconds, trace=False,
                          t_start=time.perf_counter())
    checks = {k: v["value"] for k, v in line["checks"].items()}
    print(f"control serve seed {seed}: {checks}, "
          f"{line['attempted']} requests")
    assert line["correct"] is False
