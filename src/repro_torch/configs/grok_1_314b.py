"""grok-1-314b: MoE LM, 8 experts top-2, GQA kv=8 [hf:xai-org/grok-1]."""
import torch

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMArch(LMConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv=8,
    d_ff=32768, vocab=131072, d_head=128, qkv_bias=False,
    n_experts=8, top_k=2, n_shared=0, d_ff_expert=32768,
    dtype=torch.bfloat16,
))
