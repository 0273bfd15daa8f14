"""Deterministic fault injection for the chaos test suite.

Production code marks its failure-prone boundaries with a named *site*
call::

    from ..robust import faults
    faults.maybe_fail("rig_expand")

When no plan is installed (the normal case) this is one module-global load
plus a ``None`` check — nothing is allocated, counted, or locked, so the
sites cost nothing on the warm path.  Tests install a plan::

    with faults.inject(faults.nth("device_dispatch", 1)):
        ...   # the 1st device dispatch raises InjectedFault

Triggers are **deterministic**: ``nth`` fires on exact (1-based) call
numbers, ``every`` on every k-th call, and ``probability`` draws from its
own seeded RNG — the same seed always fails the same calls, so every chaos
test replays exactly.

Sites wired through the stack:

* ``device_dispatch`` — inside :meth:`CircuitBreaker.call`, i.e. every
  governed device dispatch (vmapped matcher, intersect-kernel slabs);
* ``label_build``     — cold per-graph label construction;
* ``rig_expand``      — per query edge during RIG node expansion;
* ``journal_dispatch``— the server's batch dispatch (simulated worker
  death: requests stay journaled and are re-dispatched).
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Sequence

from .errors import InjectedFault

__all__ = ["SITES", "FaultSpec", "FaultPlan", "nth", "every", "probability",
           "inject", "install", "uninstall", "maybe_fail", "call_count"]

SITES = ("device_dispatch", "label_build", "rig_expand", "journal_dispatch")


class FaultSpec:
    """One site's trigger rule.  Exactly one of ``nth_calls`` /
    ``every_k`` / ``p`` is set; ``times`` bounds total fires (None =
    unbounded)."""

    def __init__(self, site: str, *, nth_calls: Sequence[int] = (),
                 every_k: Optional[int] = None, p: Optional[float] = None,
                 seed: int = 0, times: Optional[int] = None):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(expected one of {SITES})")
        self.site = site
        self.nth_calls = frozenset(int(n) for n in nth_calls)
        self.every_k = every_k
        self.p = p
        self.times = times
        self.fired = 0
        self._rng = random.Random(seed)

    def should_fire(self, call_no: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth_calls:
            hit = call_no in self.nth_calls
        elif self.every_k is not None:
            hit = call_no % self.every_k == 0
        elif self.p is not None:
            hit = self._rng.random() < self.p
        else:
            hit = True                       # unconditional
        if hit:
            self.fired += 1
        return hit


def nth(site: str, *call_nos: int, times: Optional[int] = None) -> FaultSpec:
    """Fire on the given 1-based call numbers at ``site``."""
    return FaultSpec(site, nth_calls=call_nos or (1,), times=times)


def every(site: str, k: int = 1, times: Optional[int] = None) -> FaultSpec:
    """Fire on every ``k``-th call at ``site`` (k=1: every call)."""
    return FaultSpec(site, every_k=k, times=times)


def probability(site: str, p: float, seed: int = 0,
                times: Optional[int] = None) -> FaultSpec:
    """Fire with probability ``p`` per call, from a private seeded RNG
    (deterministic per seed)."""
    return FaultSpec(site, p=p, seed=seed, times=times)


class FaultPlan:
    """An installed set of specs plus per-site call counters."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs: Dict[str, FaultSpec] = {}
        for s in specs:
            if s.site in self.specs:
                raise ValueError(f"duplicate spec for site {s.site!r}")
            self.specs[s.site] = s
        self.calls: Dict[str, int] = {s: 0 for s in SITES}
        self._lock = threading.Lock()

    def check(self, site: str) -> None:
        with self._lock:
            self.calls[site] = n = self.calls.get(site, 0) + 1
            spec = self.specs.get(site)
            fire = spec is not None and spec.should_fire(n)
        if fire:
            raise InjectedFault(site, n)


_PLAN: Optional[FaultPlan] = None


def maybe_fail(site: str) -> None:
    """The production-side hook: free when no plan is installed."""
    plan = _PLAN
    if plan is not None:
        plan.check(site)


def install(*specs: FaultSpec) -> FaultPlan:
    """Install a plan (replacing any previous one); returns it so tests
    can read call counters.  Prefer the :func:`inject` context manager."""
    global _PLAN
    _PLAN = plan = FaultPlan(specs)
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


class inject:
    """``with faults.inject(spec, ...) as plan:`` — scoped installation."""

    def __init__(self, *specs: FaultSpec):
        self.specs = specs
        self.plan: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self.plan = install(*self.specs)
        return self.plan

    def __exit__(self, *exc) -> None:
        uninstall()


def call_count(site: str) -> int:
    """Calls seen at ``site`` under the currently-installed plan (0 when
    none installed) — lets tests assert a site was actually exercised."""
    plan = _PLAN
    return 0 if plan is None else plan.calls.get(site, 0)
