"""deepseek-moe-16b: fine-grained MoE — 2 shared + 64 routed top-6
[arXiv:2401.06066]."""
import torch

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMArch(LMConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16, n_kv=16,
    d_ff=1408, vocab=102400, d_head=128, qkv_bias=False,
    n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
    dtype=torch.bfloat16,
))
