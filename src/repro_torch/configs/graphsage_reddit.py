"""graphsage-reddit: 2 layers, mean aggregator, fanout 25-10
[arXiv:1706.02216].  minibatch_lg exercises the real neighbour sampler
(repro_torch.data.sampler)."""
from ..models.gnn import GNNConfig
from .base import GNNArch

CONFIG = GNNArch(GNNConfig(
    name="graphsage-reddit", arch="sage", n_layers=2, d_hidden=128,
    d_feat=602, aggregator="mean",
))
