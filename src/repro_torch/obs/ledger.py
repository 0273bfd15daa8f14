"""Device memory & transfer ledger.

The paper's central claim is that the RIG is *lightweight* — built
on-the-fly per query, never persisted — which makes host<->device byte
movement and device-resident footprint the real serving costs.  This
module is the process-wide accounting substrate for both:

* :class:`TransferLedger` — byte-exact counters for every h2d / d2h
  transfer, attributed to a named *site* (which dispatch path moved the
  bytes) and a *key* (which graph / tenant they were moved for).  Charged
  bytes equal dispatched bytes: every charge is computed from the same
  :mod:`repro_torch.core.slabgeom` padded-shape geometry the kernels dispatch
  with, at the exact point the transfer happens.
* :class:`ResidentLedger` — live device-resident allocations (the packed
  resident-RIG matrices) with charge/credit semantics and a conservation
  invariant: ``charged_bytes - credited_bytes == live_bytes()`` at all
  times.  A process-wide high-watermark gauge records the worst-case
  resident footprint ever reached.

Both ledgers keep authoritative plain-int state under a lock (cheap
enough for dispatch-rate call sites — device dispatch dwarfs a dict
update) and *publish* into a :class:`~repro_torch.obs.metrics.MetricsRegistry`
on demand, so exposition (``Engine.metrics_text`` / ``prometheus_text``)
always reflects the current totals without the hot path touching metric
objects.

Sites
-----
======================  ====================================================
``slab_ship``           padded ``(F, K, W)`` uint64 constraint slabs shipped
                        by the slab-path :class:`DeviceIntersector` (h2d),
                        and the AND-row / count readback (d2h)
``resident_upload``     one-time packed resident-RIG matrix upload
``index_vectors``       per-level ``(F, K)`` int32 row-index vectors shipped
                        by the resident path (h2d) and count readback (d2h)
``pair_extract_d2h``    device-expand pair pages / accumulator rows fetched
                        back to the host (d2h only)
``label_build``         :func:`device_graph.from_host` label / adjacency /
                        reachability matrix uploads
======================  ====================================================

The transfer side has an arm/disarm lever (:attr:`TransferLedger.enabled`)
so the CI smoke gate can measure ledger-armed overhead against a disarmed
run.  The resident side is *always* armed: charge/credit are rare
lifecycle events (upload / evict) and disarming them would break the
conservation invariant.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

from .metrics import MetricsRegistry

__all__ = ["SITES", "TransferLedger", "ResidentLedger", "Ledger",
           "LEDGER", "get_ledger"]

#: Known transfer / allocation sites (unknown sites are accepted but these
#: are the ones the engine's dispatch paths charge).
SITES = ("slab_ship", "resident_upload", "index_vectors",
         "pair_extract_d2h", "label_build")

#: Attribution key used when the caller has no graph/tenant identity.
ANON_KEY = "-"


class TransferLedger:
    """Byte counters for h2d / d2h traffic per (site, key)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (site, key) -> [bytes, calls]
        self._h2d: Dict[Tuple[str, str], List[int]] = {}
        self._d2h: Dict[Tuple[str, str], List[int]] = {}
        self.enabled: bool = True

    # ------------------------------------------------------------- record
    def h2d(self, site: str, nbytes: int, key: str = ANON_KEY) -> None:
        if not self.enabled or nbytes <= 0:
            return
        with self._lock:
            cell = self._h2d.setdefault((site, key), [0, 0])
            cell[0] += int(nbytes)
            cell[1] += 1

    def d2h(self, site: str, nbytes: int, key: str = ANON_KEY) -> None:
        if not self.enabled or nbytes <= 0:
            return
        with self._lock:
            cell = self._d2h.setdefault((site, key), [0, 0])
            cell[0] += int(nbytes)
            cell[1] += 1

    # -------------------------------------------------------------- query
    @staticmethod
    def _total(table: Dict[Tuple[str, str], List[int]],
               site: Optional[str], key: Optional[str], field: int) -> int:
        return sum(cell[field] for (s, k), cell in table.items()
                   if (site is None or s == site)
                   and (key is None or k == key))

    def h2d_bytes(self, site: Optional[str] = None,
                  key: Optional[str] = None) -> int:
        with self._lock:
            return self._total(self._h2d, site, key, 0)

    def d2h_bytes(self, site: Optional[str] = None,
                  key: Optional[str] = None) -> int:
        with self._lock:
            return self._total(self._d2h, site, key, 0)

    def h2d_calls(self, site: Optional[str] = None,
                  key: Optional[str] = None) -> int:
        with self._lock:
            return self._total(self._h2d, site, key, 1)

    def d2h_calls(self, site: Optional[str] = None,
                  key: Optional[str] = None) -> int:
        with self._lock:
            return self._total(self._d2h, site, key, 1)

    def rows(self) -> List[Tuple[str, str, str, int, int]]:
        """Snapshot: ``(direction, site, key, bytes, calls)`` tuples."""
        with self._lock:
            out = [("h2d", s, k, c[0], c[1])
                   for (s, k), c in self._h2d.items()]
            out += [("d2h", s, k, c[0], c[1])
                    for (s, k), c in self._d2h.items()]
        return sorted(out)

    def reset(self) -> None:
        with self._lock:
            self._h2d.clear()
            self._d2h.clear()

    # ------------------------------------------------------------ publish
    def publish(self, registry: MetricsRegistry) -> None:
        """Sync cumulative totals into ``registry`` (per-site counters,
        aggregated over keys to keep exposition cardinality bounded; the
        per-key breakdown stays available programmatically)."""
        with self._lock:
            per_site: Dict[Tuple[str, str], List[int]] = {}
            for (s, _k), cell in self._h2d.items():
                agg = per_site.setdefault(("h2d", s), [0, 0])
                agg[0] += cell[0]
                agg[1] += cell[1]
            for (s, _k), cell in self._d2h.items():
                agg = per_site.setdefault(("d2h", s), [0, 0])
                agg[0] += cell[0]
                agg[1] += cell[1]
        for (direction, site), (nbytes, calls) in sorted(per_site.items()):
            c = registry.counter(f"ledger_{direction}_bytes", site=site)
            c.value = nbytes
            c = registry.counter(f"ledger_{direction}_calls", site=site)
            c.value = calls


class ResidentLedger:
    """Live device-resident allocations with conservation accounting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next_id = 0
        # alloc id -> (key, nbytes)
        self._live: Dict[int, Tuple[str, int]] = {}
        self.charged_bytes = 0
        self.credited_bytes = 0
        self.watermark_bytes = 0
        # keys ever published, so a fully-credited graph's gauge drops to 0
        # instead of silently freezing at its last value
        self._published_keys: set = set()

    # ----------------------------------------------------- charge / credit
    def charge(self, key: str, nbytes: int) -> int:
        """Record ``nbytes`` becoming device-resident for ``key``; returns
        an allocation id to later :meth:`credit`."""
        nbytes = int(nbytes)
        with self._lock:
            self._next_id += 1
            aid = self._next_id
            self._live[aid] = (key, nbytes)
            self.charged_bytes += nbytes
            live = self.charged_bytes - self.credited_bytes
            if live > self.watermark_bytes:
                self.watermark_bytes = live
            return aid

    def credit(self, alloc_id: Optional[int]) -> int:
        """Record the allocation being freed; idempotent (crediting an
        unknown/already-credited id is a no-op returning 0)."""
        if alloc_id is None:
            return 0
        with self._lock:
            entry = self._live.pop(alloc_id, None)
            if entry is None:
                return 0
            self.credited_bytes += entry[1]
            return entry[1]

    # -------------------------------------------------------------- query
    def live_bytes(self, key: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for k, n in self._live.values()
                       if key is None or k == key)

    def per_key(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        with self._lock:
            for k, n in self._live.values():
                out[k] = out.get(k, 0) + n
        return out

    def conserved(self) -> bool:
        """The ledger invariant: every charged byte is either still live
        or has been credited back."""
        with self._lock:
            live = sum(n for _k, n in self._live.values())
            return self.charged_bytes - self.credited_bytes == live

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self.charged_bytes = 0
            self.credited_bytes = 0
            self.watermark_bytes = 0
            self._published_keys.clear()

    # ------------------------------------------------------------ publish
    def publish(self, registry: MetricsRegistry) -> None:
        per_key = self.per_key()
        with self._lock:
            charged, credited = self.charged_bytes, self.credited_bytes
            watermark = self.watermark_bytes
            self._published_keys.update(per_key)
            keys = sorted(self._published_keys)
        c = registry.counter("ledger_resident_charged_bytes")
        c.value = charged
        c = registry.counter("ledger_resident_credited_bytes")
        c.value = credited
        registry.gauge("ledger_resident_watermark_bytes").set(watermark)
        registry.gauge("ledger_resident_live_bytes").set(
            charged - credited)
        for k in keys:
            registry.gauge("ledger_resident_live_bytes",
                           graph=k).set(per_key.get(k, 0))


class Ledger:
    """The pair of ledgers behind one handle (``get_ledger()``)."""

    def __init__(self) -> None:
        self.transfers = TransferLedger()
        self.resident = ResidentLedger()

    def publish(self, registry: MetricsRegistry) -> None:
        self.transfers.publish(registry)
        self.resident.publish(registry)

    def reset(self) -> None:
        self.transfers.reset()
        self.resident.reset()

    def arm(self) -> None:
        self.transfers.enabled = True

    def disarm(self) -> None:
        """Disable transfer recording (the dispatch-rate path).  Resident
        charge/credit stay armed — they are rare lifecycle events and the
        conservation invariant must hold regardless."""
        self.transfers.enabled = False

    def rollup(self, key: str) -> Dict[str, int]:
        """Per-graph/tenant byte rollup for ``key`` (serving surface)."""
        return {
            "h2d_bytes": self.transfers.h2d_bytes(key=key),
            "d2h_bytes": self.transfers.d2h_bytes(key=key),
            "resident_live_bytes": self.resident.live_bytes(key=key),
            "resident_watermark_bytes": self.resident.watermark_bytes,
        }


#: Process-global ledger.  Device memory and the intersector singletons are
#: process-wide, so their accounting is too (mirroring ``obs.metrics.REGISTRY``).
LEDGER = Ledger()


def get_ledger() -> Ledger:
    return LEDGER
