"""The device-resident data graph of the whole-graph matcher, and the
packing of a RIG into the one matrix the resident executor uploads.

:class:`DeviceGraph` holds the four packed operand matrices of the §5.5
bitset algebra — adjacency, reachability closure, and their transposes —
as int32 lanes padded to a block multiple, plus the node labels, all on
one device.  The four matrices are views into one ``(4, n_pad, W)``
stack, allocated once by :func:`from_host`; :func:`stacked_matrices`
returns that stack itself.  The closure comes from the host reachability
index, or is computed on the device from the uploaded adjacency
(``closure_on_device``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..core.graph import DataGraph
from ..kernels import ops
from ..obs.ledger import get_ledger
from .frontier import resolve

PAD_LABEL = -2  # label id of padding nodes: never matches any query label


@dataclass
class DeviceGraph:
    n: int                  # real node count
    n_pad: int              # padded universe (multiple of block)
    labels: torch.Tensor    # int32 (n_pad,), PAD_LABEL on padding
    stack: torch.Tensor     # int32 lanes (4, n_pad, n_pad/32):
                            # [adj, reach, adj_t, reach_t]
    build_s: float = 0.0    # host repack seconds
    upload_s: float = 0.0   # host -> device copy seconds (fenced)
    closure_s: float = 0.0  # on-device closure + transpose seconds (fenced;
                            # 0 when the closure came from the host index)
    nbytes: int = 0         # bytes shipped (labels + the matrices uploaded)

    @property
    def adj(self) -> torch.Tensor:          # children rows
        return self.stack[0]

    @property
    def reach(self) -> torch.Tensor:        # descendant rows (path >= 1)
        return self.stack[1]

    @property
    def adj_t(self) -> torch.Tensor:        # parents rows
        return self.stack[2]

    @property
    def reach_t(self) -> torch.Tensor:      # ancestor rows
        return self.stack[3]

    @property
    def n_words(self) -> int:
        return self.n_pad // 32

    @property
    def device(self) -> torch.device:
        return self.stack.device


def _lanes(words64: np.ndarray, n: int) -> torch.Tensor:
    """Host uint64-packed rows over universe ``n`` -> their first
    ``ceil(n / 32)`` int32 lanes: a view of the host words (little-endian
    uint64 = two uint32 lanes), never an unpacked matrix."""
    rows = words64.shape[0]
    lanes = np.ascontiguousarray(words64).view(np.int32).reshape(rows, -1)
    return torch.from_numpy(lanes[:, :(n + 31) // 32])


def from_host(graph: DataGraph, block: int = 512,
              closure_on_device: bool = False, device=None) -> DeviceGraph:
    """Pack ``graph`` for the whole-graph matcher and upload it to
    ``device`` (resolved as the executors do: the card unless the CPU is
    pinned).  Each uploaded matrix is the host's packed rows re-viewed as
    uint32 lanes and zero-padded to ``(n_pad, n_pad / 32)``, byte-equal to
    the JAX package's ``from_host``.

    By default the closure comes from the host reachability index, and the
    ledger's ``label_build`` h2d charge is the JAX package's: labels and
    four matrices.  With ``closure_on_device`` the host index is never
    built: ``transitive_closure`` squares the uploaded adjacency on the
    device into ``reach`` and :func:`repro_torch.kernels.ops.transpose`
    writes ``reach_t``, so only labels, ``adj`` and ``adj_t`` are shipped
    and charged (the JAX package charges all four matrices there too,
    because it pulls the closure back to the host and uploads it again).
    ``closure_s`` is that device work, ending at a fenced sync."""
    dev = resolve(device)
    t0 = time.perf_counter()
    n = graph.n
    n_pad = ((n + block - 1) // block) * block
    w = n_pad // 32
    labels = np.full(n_pad, PAD_LABEL, dtype=np.int32)
    labels[:n] = graph.labels
    if closure_on_device:
        host = {0: graph.adj_bits(), 2: graph.adj_bits_t()}
    else:
        ridx = graph.reachability()
        host = {0: graph.adj_bits(), 1: ridx.reach_bits,
                2: graph.adj_bits_t(), 3: ridx.bits_t()}
    host = {i: _lanes(m, n) for i, m in host.items()}
    t1 = time.perf_counter()
    stack = torch.zeros((4, n_pad, w), dtype=torch.int32, device=dev)
    for i, lanes in host.items():
        stack[i, :lanes.shape[0], :lanes.shape[1]] = lanes.to(dev)
    if n % 32:          # bits at n and above never count: clear the tail
        stack[:, :, n // 32] &= (1 << (n % 32)) - 1
    labels_t = torch.from_numpy(labels).to(dev)
    _fence(dev)
    t2 = time.perf_counter()
    closure_s = 0.0
    if closure_on_device:
        ops.transitive_closure(stack[0], out=stack[1])
        ops.transpose(stack[1], out=stack[3])
        _fence(dev)
        closure_s = time.perf_counter() - t2
    shipped = labels.nbytes + len(host) * n_pad * w * 4
    get_ledger().transfers.h2d("label_build", shipped,
                               getattr(graph, "graph_key", "-"))
    return DeviceGraph(n=n, n_pad=n_pad, labels=labels_t, stack=stack,
                       build_s=t1 - t0, upload_s=t2 - t1, closure_s=closure_s,
                       nbytes=shipped)


def _fence(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stacked_matrices(dg: DeviceGraph) -> torch.Tensor:
    """(4, n_pad, W) stacked [adj, reach, adj_t, reach_t] — lets the
    enumerator pick the operand with one flat gather:
    matrix id = 2 * is_backward + (kind == DESC).  This is the graph's
    own stack, not a copy."""
    return dg.stack


def pack_resident_rig(rig) -> Tuple[np.ndarray, List[int], List[int], int]:
    """Concatenate a RIG's per-edge packed adjacency into one uint32
    matrix for the resident gather-intersect path.

    Every ``rig.fwd[e]`` / ``rig.bwd[e]`` uint64 matrix is re-viewed as
    little-endian uint32 lanes (bit-compatible with the host packing) and
    stacked row-wise into ``(R, W)`` with ``W`` = the widest edge's lane
    count rounded to 128; rows are zero-extended beyond their true width,
    so AND/popcount over the common width is exact.  A dedicated all-zero
    row is appended last — index padding targets it so padded dispatch
    rows contribute nothing.

    Returns ``(matrix32, fwd_off, bwd_off, zero_row)``: constraint row
    ``(edge e, forward, local src id i)`` lives at ``fwd_off[e] + i``
    (``bwd_off[e] + i`` for backward rows).  The matrix is byte-equal to
    the JAX package's packing of the same RIG.

    Resident footprint: ``(Σ_e |cos(src_e)| + |cos(dst_e)| + 1) * W * 4``
    bytes — linear in RIG nodes per edge, not in enumerated frontiers.
    """
    mats = list(rig.fwd) + list(rig.bwd)
    w_lanes = 128
    for m in mats:
        w_lanes = max(w_lanes, 2 * m.shape[1])
    w_lanes = -(-w_lanes // 128) * 128
    rows = sum(m.shape[0] for m in mats) + 1          # + the all-zero row
    matrix = np.zeros((rows, w_lanes), dtype=np.uint32)
    fwd_off: List[int] = []
    bwd_off: List[int] = []
    off = 0
    for offs, group in ((fwd_off, rig.fwd), (bwd_off, rig.bwd)):
        for m in group:
            offs.append(off)
            s, w64 = m.shape
            if s:
                matrix[off:off + s, :2 * w64] = np.ascontiguousarray(
                    m).view(np.uint32).reshape(s, 2 * w64)
            off += s
    return matrix, fwd_off, bwd_off, rows - 1
