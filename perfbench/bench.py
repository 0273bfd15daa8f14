"""One run of one cell: set-up, the measured window, the device trace, the
comparison with the plain reference, and the result line.

Everything particular to a configuration, a traffic mix or a metric lives
in files of its own that this module finds by name:

* ``BENCHMARK.json`` names the cell's configuration and traffic;
* ``perfbench/configs/<config>.json`` names its driver
  (``perfbench/drivers/<driver>.py``), which sets up the system under test,
  drives its window and compares its answers with the reference;
* ``perfbench/traffic/<traffic>.json`` holds the mix's parameters;
* ``perfbench/metrics/<metric>.py`` reads one per-layer metric.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
# top-level modules that may not be loaded in a run: the JAX stack and the
# JAX package the port was made from (names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Window:
    """What the measured window served: the latency of every answered
    request (seconds), and the window's length from its first submission
    to the end of its last step."""
    latencies: List[float] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    answered: int = 0      # answered by the window's close (for the rate)


@dataclass
class Context:
    """What the per-layer readers read (``perfbench/metrics/*.py``)."""
    rec: object                       # perfbench.spans.Recorder
    values: Dict[str, object]         # the driver's readings
    trace: Optional[object]           # perfbench.trace.TraceSummary


def load_cell(name: str, manifest_path: Optional[Path] = None) -> Cell:
    manifest = json.loads((manifest_path or ROOT / "BENCHMARK.json")
                          .read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in "
                         f"BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
                per_layer=[m for m in manifest["per_layer"] if mine(m)])


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             t_start: float) -> dict:
    """One run on the port's device (the card; the CPU only where a test
    pins it); returns the result line's object (its ``checks`` last)."""
    import torch
    from repro_torch.torchgm import frontier
    from . import spans
    from . import trace as tracing

    driver = importlib.import_module(
        f"perfbench.drivers.{cell.config['driver']}")
    dev = frontier.resolve()
    cuda = dev.type == "cuda"
    state = driver.setup(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    rec = spans.Recorder(annotate=trace)
    if trace:
        driver.instrument(state, rec)

    def window() -> Window:
        with rec.span("window"):
            return driver.window(state, seconds, rec)

    summary = None
    try:
        if trace:
            win, events = tracing.profile(window)
            t0 = time.perf_counter()
            summary = tracing.summarize(events)
            del events
            if summary is not None:
                print(f"trace: {summary.ops} device operations in the "
                      f"window, {summary.unlinked} without a launch record, "
                      f"summarized in {time.perf_counter() - t0:.1f} s",
                      file=sys.stderr)
        else:
            win = window()
    finally:
        rec.restore()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if win.latencies:
        lat = sorted(win.latencies)
        q = [lat[int(f * (len(lat) - 1))] * 1e3 for f in (0.1, 0.5, 0.9)]
        print(f"window: {len(lat)} answered in {win.seconds:.3f} s; latency "
              f"ms p10 {q[0]:.3f} p50 {q[1]:.3f} p90 {q[2]:.3f} max "
              f"{lat[-1] * 1e3:.3f}", file=sys.stderr)
    values = driver.readings(state, rec) if trace else {}
    driver.teardown(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(state)
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())

    metrics = {}
    if trace:
        ctx = Context(rec=rec, values=values, trace=summary)
        for m in cell.per_layer:
            reader = importlib.import_module(f"perfbench.metrics.{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"qps": win.answered / win.seconds if win.seconds else 0.0,
               "p95_ms": (p95(win.latencies) * 1e3 if win.latencies
                          else None),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and summary is not None:
        info["busy_s"] = summary.busy_s
        info["window_s"] = summary.window_s
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": info}
    if trace and summary is not None:
        out["breakdown"] = summary.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
