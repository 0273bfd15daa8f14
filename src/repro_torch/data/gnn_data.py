"""Synthetic GraphBatch builders for the four assigned GNN shapes.

``GNNArch._abstract_batch`` in the configs uses the same shape logic on
``meta`` tensors (no allocation); these builders create *real* numpy
batches for the smoke tests, the launcher and the card run.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def full_graph_batch(n_nodes: int, n_edges: int, d_feat: int,
                     n_classes: int = 16, seed: int = 0,
                     with_labels: bool = True) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {
        "node_feat": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        "edge_src": rng.integers(0, n_nodes, n_edges).astype(np.int32),
        "edge_dst": rng.integers(0, n_nodes, n_edges).astype(np.int32),
        "node_mask": np.ones(n_nodes, bool),
    }
    if with_labels:
        out["labels"] = rng.integers(0, n_classes, n_nodes).astype(np.int32)
        out["train_mask"] = rng.random(n_nodes) < 0.5
    return out


def schnet_batch(n_nodes: int, n_edges: int, d_feat: int, batch: int = 1,
                 cutoff: float = 10.0, seed: int = 0) -> Dict[str, np.ndarray]:
    """Batched molecules: ``batch`` graphs of n_nodes/n_edges each, flattened
    with graph_ids; edge_feat[:, 0] = interatomic distance (the modality
    frontend stub supplies geometry)."""
    rng = np.random.default_rng(seed)
    N, E = n_nodes * batch, n_edges * batch
    src = rng.integers(0, n_nodes, E)
    dst = rng.integers(0, n_nodes, E)
    offs = np.repeat(np.arange(batch) * n_nodes, n_edges)
    return {
        "node_feat": rng.standard_normal((N, d_feat)).astype(np.float32),
        "edge_src": (src + offs).astype(np.int32),
        "edge_dst": (dst + offs).astype(np.int32),
        "edge_feat": (rng.random((E, 1)) * cutoff).astype(np.float32),
        "node_mask": np.ones(N, bool),
        "graph_ids": np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        "graph_targets": rng.standard_normal(batch).astype(np.float32),
    }


def graphcast_batch(n_grid: int, n_mesh: int, n_vars: int,
                    mesh_edges: int, g2m_edges: int, m2g_edges: int,
                    d_mesh: int = 3, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    d_edge = 4
    return {
        "node_feat": rng.standard_normal((n_grid, n_vars)).astype(np.float32),
        "mesh_feat": rng.standard_normal((n_mesh, d_mesh)).astype(np.float32),
        "g2m_src": rng.integers(0, n_grid, g2m_edges).astype(np.int32),
        "g2m_dst": rng.integers(0, n_mesh, g2m_edges).astype(np.int32),
        "g2m_feat": rng.standard_normal((g2m_edges, d_edge)).astype(np.float32),
        "mesh_src": rng.integers(0, n_mesh, mesh_edges).astype(np.int32),
        "mesh_dst": rng.integers(0, n_mesh, mesh_edges).astype(np.int32),
        "mesh_efeat": rng.standard_normal((mesh_edges, d_edge)).astype(np.float32),
        "m2g_src": rng.integers(0, n_mesh, m2g_edges).astype(np.int32),
        "m2g_dst": rng.integers(0, n_grid, m2g_edges).astype(np.int32),
        "m2g_feat": rng.standard_normal((m2g_edges, d_edge)).astype(np.float32),
        "node_mask": np.ones(n_grid, bool),
        "labels": rng.standard_normal((n_grid, n_vars)).astype(np.float32),
    }
