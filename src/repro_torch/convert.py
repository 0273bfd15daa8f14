"""Carry the reference's state across to the port.

The matcher has no weights: its state is the data graph, the pattern
queries, the packed data graph of the whole-graph matcher and, on the
resident path, the packed RIG matrix on the device.  The model
substrate's state (LM, GNN, DIN) is its parameter tree and its AdamW
state.
These functions take plain numpy arrays and tuples (for example the
fields of a reference ``DataGraph``, the matrix its resident packing
returns, or a reference parameter tree passed through ``np.asarray``) and
build the port's objects from them, without importing the reference
package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

import torch

from .core.graph import DataGraph
from .core.query import PatternQuery, QueryEdge
from .models import gnn, recsys
from .models import transformer as tf
from .train import tree as tr
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


def _leaf(arr, shape, dtype, device, name: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
    if arr.dtype.kind not in "iub":
        arr = arr.astype(np.float32)     # bfloat16 (ml_dtypes) and friends
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _tree(tree: Dict[str, Any], shapes: Dict[str, Any], dtype, device,
          name: str, path: str = "") -> Dict[str, Any]:
    if not isinstance(tree, dict) or set(tree) != set(shapes):
        raise ValueError(f"parameter tree keys{' at ' + path if path else ''}"
                         f" differ from {name}'s")
    return {k: (_tree(tree[k], s, dtype, device, name, f"{path}{k}/")
                if isinstance(s, dict)
                else _leaf(tree[k], s, dtype, device, f"{path}{k}"))
            for k, s in sorted(shapes.items())}


def params_from_numpy(tree: Dict[str, Any], cfg, device=None
                      ) -> Dict[str, Any]:
    """The port's parameter tree from the reference's, leaves as numpy
    arrays, for an ``LMConfig`` (``{"embed", "final_ln", "lm_head",
    "layers": {...}}``, stacked layers), a ``GNNConfig`` (``{"proj":
    {"w0", "b0"}, "eps0", ...}``) or a ``DINConfig`` (flat): keys equal
    to the shapes ``cfg`` gives, each leaf checked against its shape and
    cast to ``cfg.dtype`` on ``device``."""
    shapes = _PARAM_SHAPES[type(cfg)](cfg)
    return _tree(tree, shapes, cfg.dtype, resolve(device), cfg.name)


_PARAM_SHAPES = {tf.LMConfig: tf.param_shapes,
                 gnn.GNNConfig: gnn.param_shapes,
                 recsys.DINConfig: recsys.param_shapes}


def adamw_state_from_numpy(state: Dict[str, Any], device=None
                           ) -> Dict[str, Any]:
    """The port's AdamW state (``repro_torch.train.optimizer``) from the
    reference's, leaves as numpy arrays: ``step`` as an int32 scalar,
    ``m`` and ``v`` as float32 trees of the parameters' shape."""
    dev = resolve(device)
    f32 = lambda a: _leaf(a, np.shape(a), torch.float32, dev, "m/v")  # noqa: E731
    return {"step": _leaf(state["step"], (), torch.int32, dev, "step"),
            "m": tr.map_tree(f32, state["m"]),
            "v": tr.map_tree(f32, state["v"])}
