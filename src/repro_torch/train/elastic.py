"""Elastic / fault-tolerant training orchestration.

The contract with the cluster scheduler:

* every job step is **deterministic given (params, opt_state, data_step)** —
  the data pipeline is seeded by step index, so restart = restore + replay;
* node failure → the launcher restarts from the survivors (or a new
  allocation), restores the latest checkpoint onto the new job's devices
  (``Checkpointer.restore`` places each leaf as its template does), and
  resumes;
* stragglers: synchronous steps; a step exceeding ``straggler_factor``×
  the trailing-median step time flags the step in the journal (the
  single-process build can only record the signal).

``ElasticTrainer`` packages that loop so tests can kill/resume it
deterministically.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import tree as tr
from .checkpoint import Checkpointer


@dataclass
class ElasticConfig:
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    checkpoint_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    async_save: bool = True


class StepJournal:
    """Rolling step-time stats + straggler flags (host-side telemetry)."""

    def __init__(self, window: int = 64):
        self.times: List[float] = []
        self.window = window
        self.flags: List[int] = []

    def record(self, step: int, dt: float, factor: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        straggler = len(self.times) >= 8 and dt > factor * med
        if straggler:
            self.flags.append(step)
        return straggler


def _fence(state) -> None:
    """Wait for the step's device work (the reference's
    ``block_until_ready`` on the state's first leaf)."""
    first = tr.leaves(state)[0]
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.synchronize(first.device)


class ElasticTrainer:
    """step_fn: (state, batch) -> (state, metrics); state is any tree
    with the optimizer step retrievable via ``get_step(state)``."""

    def __init__(self, step_fn: Callable, make_batch: Callable[[int], Any],
                 init_state: Callable[[], Any], cfg: ElasticConfig,
                 get_step: Callable[[Any], int]):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.init_state = init_state
        self.cfg = cfg
        self.get_step = get_step
        self.ckpt = Checkpointer(cfg.checkpoint_dir, keep=cfg.keep)
        self.journal = StepJournal()
        self.state = None

    # ------------------------------------------------------------ lifecycle
    def start_or_resume(self):
        template = self.init_state()
        latest = self.ckpt.latest_step()
        if latest is not None:
            self.state, meta = self.ckpt.restore(template, step=latest)
            return {"resumed": True, "step": latest}
        self.state = template
        return {"resumed": False, "step": 0}

    def run(self, n_steps: int, fail_at: Optional[int] = None) -> Dict:
        """Run up to ``n_steps`` *total* optimizer steps.  ``fail_at``
        injects a simulated crash (raises) after that step — the test
        harness then constructs a fresh trainer and calls
        start_or_resume()."""
        if self.state is None:
            raise RuntimeError("call start_or_resume() first")
        metrics_log = []
        while True:
            step = int(self.get_step(self.state))
            if step >= n_steps:
                break
            batch = self.make_batch(step)         # seeded by step => replayable
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            _fence(self.state)
            dt = time.perf_counter() - t0
            self.journal.record(step, dt, self.cfg.straggler_factor)
            metrics_log.append({k: float(v) for k, v in metrics.items()})
            new_step = int(self.get_step(self.state))
            if new_step % self.cfg.checkpoint_every == 0:
                if self.cfg.async_save:
                    self.ckpt.save_async(new_step, self.state)
                else:
                    self.ckpt.save(new_step, self.state)
            if fail_at is not None and new_step >= fail_at:
                self.ckpt.wait()
                raise SimulatedFailure(new_step)
        self.ckpt.wait()
        final = int(self.get_step(self.state))
        if not self.ckpt.all_steps() or self.ckpt.latest_step() != final:
            self.ckpt.save(final, self.state)
        return {"final_step": final, "metrics": metrics_log,
                "straggler_flags": list(self.journal.flags)}


class SimulatedFailure(RuntimeError):
    def __init__(self, step: int):
        super().__init__(f"simulated node failure at step {step}")
        self.step = step
