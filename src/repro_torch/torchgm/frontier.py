"""Device executors for the host-driven frontier MJoin, on torch tensors.

``repro_torch.core.mjoin`` enumerates with host-side frontier tables;
this module holds the two device execution paths for the per-level
constraint work:

* :class:`DeviceIntersector` — the *slab-shipping* path
  (``frontier-device``): the host gathers the ``(F, K, W)`` constraint
  rows, ships the slab, and the ``intersect`` kernel AND-reduces and
  popcounts it.
* :class:`ResidentIntersector` — the *resident* path
  (``frontier-device-resident``): every packed RIG adjacency matrix is
  concatenated and uploaded **once** after ``BuildRIG``
  (:func:`repro_torch.torchgm.device_graph.pack_resident_rig`); each level
  then ships only the ``(F, K)`` int32 constraint-row indices and the
  ``gather_intersect`` kernel does the gather + AND + popcount on the
  device.  Frontier expansion (set bits -> (row, column) pairs) runs on
  the device too (``expand_pairs``), so the host receives compact pair
  pages instead of dense slabs.

Both executors resolve a device (:func:`resolve`) and always call the
kernel wrappers, which launch the hand-written CUDA kernels on CUDA
tensors and run the plain PyTorch versions on CPU tensors.  On the CPU,
expansion fetches the AND rows and extracts pairs on the host.

With no device given and no pin, the device is the current CUDA device;
without CUDA, resolution **raises** — nothing drops silently to the CPU.
Tests pin the CPU process-wide with ``DEFAULT_DEVICE = "cpu"``.

``compile_s`` records the one-time ``nvcc`` build an executor waited for
(0 when the kernels were already built), separately from ``kernel_s``,
the per-call device time fenced with ``torch.cuda.synchronize()``.

Padding geometry (F to the next pow2 >= 128, W to a multiple of 128
lanes, K to pow2 with all-ones AND-identity rows) comes from
:mod:`repro_torch.core.slabgeom`, the same formulas budget enforcement
uses, and every ledger charge equals the bytes moved.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.slabgeom import (padded_slab_bytes, padded_slab_shape,
                             pow2_at_least, resident_dispatch_bytes,
                             resident_rows_cap, round_up)
from ..kernels import _build
from ..kernels.gather_intersect import expand_pairs, gather_intersect
from ..kernels.intersect import intersect
from ..obs.ledger import get_ledger

__all__ = ["DeviceIntersector", "ResidentIntersector", "resolve",
           "DEFAULT_DEVICE", "resident_fingerprint"]

# process-wide pin: None = auto (the current CUDA device)
DEFAULT_DEVICE: Optional[str] = None


def resolve(device=None) -> torch.device:
    """The executor's device: the explicit argument first, then the
    ``DEFAULT_DEVICE`` pin, then the current CUDA device.  Raises without
    CUDA unless a CPU device is asked for."""
    device = DEFAULT_DEVICE if device is None else device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs its executors on the "
                "card; pass device='cpu' (or set repro_torch.torchgm."
                "frontier.DEFAULT_DEVICE = 'cpu') to run the plain "
                "versions on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _build_s(device: torch.device) -> float:
    """Seconds waited for the one-time ``nvcc`` build (CUDA only)."""
    return _build.ensure_built() if device.type == "cuda" else 0.0


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resident_fingerprint(rig) -> tuple:
    """Shape signature of a RIG's packed matrices.  BuildRIG is
    deterministic per (graph, canonical query), so a cached
    :class:`ResidentIntersector` whose fingerprint matches a freshly built
    RIG was packed from identical matrices and can be re-attached without
    re-uploading."""
    return (tuple(m.shape for m in rig.fwd),
            tuple(m.shape for m in rig.bwd))


class DeviceIntersector:
    """AND-reduce + popcount one ``(F, K, W)`` uint64 frontier block.

    Callable: ``rows (F, K, W64) uint64 -> (and_rows (F, W64) uint64,
    counts (F,) int64)``.
    """

    def __init__(self, device=None):
        self.device = resolve(device)
        self.calls = 0
        self.kernel_s = 0.0       # fenced per-call device time (no build)
        self.compile_s = _build_s(self.device)
        self.peak_slab_bytes = 0  # largest padded slab actually allocated
        self.h2d_bytes = 0        # cumulative host->device slab traffic
        self.d2h_bytes = 0        # cumulative device->host readback traffic
        # ledger attribution key; the slab intersector is a process-global
        # singleton shared across graphs, so callers may retag per dispatch
        self.ledger_key = "-"

    def __call__(self, rows_u64: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        f, k, w64 = rows_u64.shape
        w = 2 * w64                                     # uint32 lanes
        rows = np.ascontiguousarray(rows_u64).view(np.uint32)
        rows = rows.reshape(f, k, w)
        fp, kp, wp = padded_slab_shape(f, k, w64)
        if (fp, kp, wp) != (f, k, w):
            padded = np.zeros((fp, kp, wp), dtype=np.uint32)
            padded[:f, :k, :w] = rows
            if kp != k:          # AND-identity rows keep real lanes intact
                padded[:f, k:, :w] = np.uint32(0xFFFFFFFF)
            rows = padded
        self.peak_slab_bytes = max(self.peak_slab_bytes,
                                   padded_slab_bytes(f, k, w64))
        # rows is padded, so rows.nbytes == padded_slab_bytes(f, k, w64):
        # the ledger charge equals the dispatched bytes by construction
        self.h2d_bytes += rows.nbytes
        get_ledger().transfers.h2d("slab_ship", rows.nbytes,
                                   self.ledger_key)
        t0 = time.perf_counter()
        slab = torch.from_numpy(rows.view(np.int32)).to(self.device)
        and32, counts = intersect(slab)
        _fence(self.device)
        self.kernel_s += time.perf_counter() - t0
        self.calls += 1
        and_np = and32.cpu().numpy()
        counts_np = counts.cpu().numpy()
        d2h = and_np.nbytes + counts_np.nbytes
        self.d2h_bytes += d2h
        get_ledger().transfers.d2h("slab_ship", d2h, self.ledger_key)
        and_rows = np.ascontiguousarray(and_np[:f, :w]).view(np.uint64)
        return and_rows, counts_np[:f].astype(np.int64)


class _ResidentSlab:
    """Opaque handle for one dispatched slab: the padded AND rows, still
    on the device, awaiting an optional :meth:`ResidentIntersector.expand`."""

    __slots__ = ("acc", "f")

    def __init__(self, acc: torch.Tensor, f: int):
        self.acc = acc
        self.f = f


class ResidentIntersector:
    """Device-resident RIG executor (see module docstring).

    Built once per RIG via :meth:`build` (cached on ``rig.resident`` by
    ``repro_torch.core.mjoin.resident_intersector``); ``nbytes`` is the
    resident matrix footprint and ``upload_s`` the fenced one-time upload.
    """

    # device->host pair pages are sized in multiples of this bucket
    PAGE_BUCKET = 1024

    def __init__(self, matrix32: np.ndarray, fwd_off: List[int],
                 bwd_off: List[int], zero_row: int, key: str = "-",
                 device=None):
        self.device = resolve(device)
        self.compile_s = _build_s(self.device)
        self.key = key
        lanes = np.ascontiguousarray(matrix32).view(np.int32)
        t0 = time.perf_counter()
        self.matrix = torch.from_numpy(lanes).to(self.device)
        _fence(self.device)
        self.upload_s = time.perf_counter() - t0
        self.nbytes = int(self.matrix.numel()) * 4
        ledger = get_ledger()
        ledger.transfers.h2d("resident_upload", self.nbytes, key)
        # the packed matrix stays device-resident until close(): charge the
        # resident ledger now, credit on close (conservation invariant)
        self._alloc = ledger.resident.charge(key, self.nbytes)
        self.rows = int(self.matrix.shape[0])
        self.w_lanes = int(self.matrix.shape[1])
        self.fwd_off = fwd_off
        self.bwd_off = bwd_off
        self.zero_row = zero_row
        self.fingerprint: Optional[tuple] = None
        self.calls = 0            # gather-intersect dispatches
        self.expand_calls = 0     # pair-page dispatches
        self.h2d_bytes = 0        # cumulative host->device index traffic
        self.d2h_bytes = 0        # cumulative device->host readback traffic
        self.kernel_s = 0.0       # fenced per-call device time (no build)
        self.peak_dispatch_bytes = 0

    @classmethod
    def build(cls, rig, device=None) -> "ResidentIntersector":
        from .device_graph import pack_resident_rig
        matrix32, fwd_off, bwd_off, zero_row = pack_resident_rig(rig)
        res = cls(matrix32, fwd_off, bwd_off, zero_row,
                  key=getattr(rig, "graph_key", "-"), device=device)
        res.fingerprint = resident_fingerprint(rig)
        return res

    @property
    def closed(self) -> bool:
        return self._alloc is None

    def close(self) -> int:
        """Release the device-resident matrix and credit the ledger.
        Idempotent; returns the bytes credited (0 if already closed)."""
        credited = get_ledger().resident.credit(self._alloc)
        self._alloc = None
        self.matrix = None
        return credited

    def __del__(self):
        # GC safety net: an executor dropped without close() must still
        # credit the ledger or the conservation invariant drifts
        try:
            self.close()
        except Exception:       # noqa: BLE001 - interpreter shutdown
            pass

    def rows_cap(self, max_bytes: int, k: int, at_most: int) -> int:
        """Largest slab height whose padded dispatch transient fits
        ``max_bytes`` (0 = infeasible: route the level through the host)."""
        return resident_rows_cap(max_bytes, k, self.w_lanes, at_most)

    # ------------------------------------------------------------------ API
    def intersect(self, cs, slab: np.ndarray, w64: int
                  ) -> Tuple[_ResidentSlab, np.ndarray]:
        """One level dispatch for one frontier slab.

        ``cs`` is the level's constraint list ``(prefix_pos, edge, isf)``
        (as built by ``repro_torch.core.mjoin._constraints``), ``slab`` the
        ``(F, i)`` frontier rows, ``w64`` the level's packed row width in
        uint64 words.  Ships only the ``(F, K)`` int32 index matrix;
        returns the on-device AND rows (handle) plus host popcounts.
        """
        f, k = len(slab), len(cs)
        idx = np.empty((f, k), dtype=np.int32)
        for c, (j, ei, isf) in enumerate(cs):
            off = self.fwd_off[ei] if isf else self.bwd_off[ei]
            idx[:, c] = off + slab[:, j]
        if f and (idx.min() < 0 or idx.max() >= self.rows):
            raise IndexError(f"constraint row index outside the resident "
                             f"matrix of {self.rows} rows")
        fp = pow2_at_least(f)
        if fp != f:
            # padding rows gather the dedicated all-zero resident row, so
            # padded AND rows are zero: counts and expands never see them
            pad = np.full((fp - f, k), self.zero_row, dtype=np.int32)
            idx = np.vstack([idx, pad])
        # idx is padded, so idx.nbytes == pow2_at_least(f) * k * 4: charged
        # bytes equal shipped bytes
        self.h2d_bytes += idx.nbytes
        get_ledger().transfers.h2d("index_vectors", idx.nbytes, self.key)
        self.peak_dispatch_bytes = max(
            self.peak_dispatch_bytes,
            resident_dispatch_bytes(f, k, self.w_lanes))
        t0 = time.perf_counter()
        acc, counts = gather_intersect(
            self.matrix, torch.from_numpy(idx).to(self.device), w32=2 * w64)
        _fence(self.device)
        self.kernel_s += time.perf_counter() - t0
        self.calls += 1
        counts_np = counts.cpu().numpy()
        self.d2h_bytes += counts_np.nbytes
        get_ledger().transfers.d2h("index_vectors", counts_np.nbytes,
                                   self.key)
        return (_ResidentSlab(acc, f),
                counts_np[:f].astype(np.int64))

    def expand(self, handle: _ResidentSlab, n_i: int, want: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """First ``want`` set-bit ``(row, column)`` pairs of a dispatched
        slab, in row-major (= lexicographic) order — computed on the
        device and shipped as one compact page (on the CPU, extracted from
        the fetched AND rows on the host)."""
        if want <= 0:
            z = np.empty(0, dtype=np.int64)
            return z, z
        if self.device.type == "cpu":
            # no card: fetch the live lanes of the AND rows and extract on
            # the host, where unpackbits + nonzero is fastest
            t0 = time.perf_counter()
            lanes = (n_i + 31) // 32
            rows = handle.acc[:handle.f, :lanes].numpy()
            self.d2h_bytes += rows.nbytes
            get_ledger().transfers.d2h("pair_extract_d2h", rows.nbytes,
                                       self.key)
            bits = np.unpackbits(np.ascontiguousarray(rows).view(np.uint8),
                                 axis=1, bitorder="little")[:, :n_i]
            rid, cid = np.nonzero(bits)
            self.kernel_s += time.perf_counter() - t0
            self.expand_calls += 1
            return rid[:want].astype(np.int64), cid[:want].astype(np.int64)
        size = round_up(want, self.PAGE_BUCKET)
        t0 = time.perf_counter()
        rid, cid = expand_pairs(handle.acc, n_i=n_i, size=size)
        _fence(self.device)
        self.kernel_s += time.perf_counter() - t0
        self.expand_calls += 1
        rid_np, cid_np = rid.cpu().numpy(), cid.cpu().numpy()
        page = rid_np.nbytes + cid_np.nbytes   # full pages ship, then slice
        self.d2h_bytes += page
        get_ledger().transfers.d2h("pair_extract_d2h", page, self.key)
        return (rid_np[:want].astype(np.int64),
                cid_np[:want].astype(np.int64))
