"""qwen2-7b: dense LM, GQA kv=4, QKV bias [arXiv:2407.10671]."""
import torch

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMArch(LMConfig(
    name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv=4,
    d_ff=18944, vocab=152064, d_head=128, qkv_bias=True,
    dtype=torch.bfloat16,
))
