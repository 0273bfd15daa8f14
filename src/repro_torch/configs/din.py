"""din: Deep Interest Network — embed_dim 18, seq 100, attn MLP 80-40,
MLP 200-80, target attention interaction [arXiv:1706.06978]."""
from ..models.recsys import DINConfig
from .base import DINArch

CONFIG = DINArch(DINConfig(
    name="din", embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
    n_items=1_000_000, n_cates=10_000, n_user_feats=8, user_feat_vocab=1_024,
))
