"""gin-tu: Graph Isomorphism Network, 5 layers, sum aggregator, learnable
eps [arXiv:1810.00826]."""
from ..models.gnn import GNNConfig
from .base import GNNArch

CONFIG = GNNArch(GNNConfig(
    name="gin-tu", arch="gin", n_layers=5, d_hidden=64, d_feat=1433,
    aggregator="sum", learnable_eps=True,
))
