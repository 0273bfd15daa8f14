"""graphcast: encoder-processor-decoder mesh GNN, 16 layers, d=512,
n_vars=227 [arXiv:2212.12794].  The grid frontend is a stub: the batch
supplies precomputed per-node feature vectors."""
from ..models.gnn import GNNConfig
from .base import GNNArch

CONFIG = GNNArch(GNNConfig(
    name="graphcast", arch="graphcast", n_layers=16, d_hidden=512,
    d_feat=227, n_vars=227, mesh_refinement=6, aggregator="sum",
))
