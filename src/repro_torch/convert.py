"""Carry the reference's state across to the port.

The system has no weights: its state is the data graph, the pattern
queries, the packed data graph of the whole-graph matcher and, on the
resident path, the packed RIG matrix on the device.
These functions take plain numpy arrays and tuples (for example the
fields of a reference ``DataGraph`` or the matrix its resident packing
returns) and build the port's objects from them, without importing the
reference package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

import torch

from .core.graph import DataGraph
from .core.query import PatternQuery, QueryEdge
from .torchgm.device_graph import DeviceGraph
from .torchgm.frontier import ResidentIntersector, resolve


def graph_from_arrays(n: int, labels, num_labels: int, edges) -> DataGraph:
    """A data graph of ``n`` nodes: ``labels`` (n,) ints below
    ``num_labels``, ``edges`` (E, 2) ``(src, dst)`` node ids."""
    labels = np.asarray(labels, dtype=np.int32)
    if labels.shape != (n,):
        raise ValueError(f"labels must have shape ({n},), got "
                         f"{labels.shape}")
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size and (edges.min() < 0 or edges.max() >= n):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    return DataGraph(n=n, labels=labels, num_labels=num_labels, edges=edges)


def query_from_spec(labels: Sequence[int],
                    edges: Sequence[Tuple[int, int, int]],
                    name: str = "") -> PatternQuery:
    """A pattern query: one label per query node and ``(src, dst, kind)``
    edges with ``kind`` 0 for a child edge, 1 for a descendant edge."""
    return PatternQuery(labels=[int(x) for x in labels],
                        edges=[QueryEdge(int(s), int(d), int(k))
                               for s, d, k in edges],
                        name=name)


def resident_from_packed(matrix32: np.ndarray, fwd_off: List[int],
                         bwd_off: List[int], zero_row: int, device=None,
                         key: str = "-") -> ResidentIntersector:
    """Wrap an already packed resident matrix (uint32 ``(R, W)``, the
    layout of :func:`repro_torch.torchgm.device_graph.pack_resident_rig`)
    in the port's executor, uploaded to ``device``."""
    matrix32 = np.asarray(matrix32)
    if matrix32.dtype not in (np.uint32, np.int32) or matrix32.ndim != 2:
        raise ValueError(f"matrix32 must be a 2-D uint32 matrix, got "
                         f"{matrix32.dtype} {matrix32.shape}")
    if not 0 <= zero_row < matrix32.shape[0]:
        raise ValueError(f"zero_row {zero_row} outside the matrix")
    return ResidentIntersector(matrix32, [int(o) for o in fwd_off],
                               [int(o) for o in bwd_off], int(zero_row),
                               key=key, device=device)


def device_graph_from_packed(n: int, n_pad: int, labels, adj, adj_t, reach,
                             reach_t, device=None) -> DeviceGraph:
    """The whole-graph matcher's packed data graph from numpy arrays (for
    example the fields of a reference ``DeviceGraph``): ``labels`` int32
    ``(n_pad,)`` and four uint32 ``(n_pad, n_pad / 32)`` matrices,
    uploaded as one stack to ``device``."""
    mats = [np.ascontiguousarray(m) for m in (adj, reach, adj_t, reach_t)]
    for m in mats:
        if m.dtype not in (np.uint32, np.int32) or m.shape != (n_pad,
                                                                n_pad // 32):
            raise ValueError(f"each matrix must be uint32 ({n_pad}, "
                             f"{n_pad // 32}), got {m.dtype} {m.shape}")
    labels = np.array(labels, dtype=np.int32)
    if labels.shape != (n_pad,):
        raise ValueError(f"labels must have shape ({n_pad},)")
    dev = resolve(device)
    stack = torch.from_numpy(np.stack([m.view(np.int32) for m in mats]))
    return DeviceGraph(n=n, n_pad=n_pad,
                       labels=torch.from_numpy(labels).to(dev),
                       stack=stack.to(dev),
                       nbytes=labels.nbytes + stack.numel() * 4)
