"""yi-34b: llama-arch dense LM with GQA [arXiv:2403.04652; hf]."""
import torch

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMArch(LMConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv=8,
    d_ff=20480, vocab=64000, d_head=128, qkv_bias=False,
    dtype=torch.bfloat16,
))
