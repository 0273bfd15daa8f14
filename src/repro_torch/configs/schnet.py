"""schnet: continuous-filter convolutions, 3 interactions, 300 RBF,
cutoff 10 Å [arXiv:1706.08566].  Geometry (edge distances) comes from the
input pipeline (neighbor-list stub)."""
from ..models.gnn import GNNConfig
from .base import GNNArch

CONFIG = GNNArch(GNNConfig(
    name="schnet", arch="schnet", n_layers=3, d_hidden=64, d_feat=16,
    n_rbf=300, cutoff=10.0, aggregator="sum",
))
