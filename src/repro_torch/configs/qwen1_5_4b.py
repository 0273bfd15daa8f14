"""qwen1.5-4b: dense LM with QKV bias (MHA: kv == heads) [hf:Qwen/Qwen1.5]."""
import torch

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMArch(LMConfig(
    name="qwen1.5-4b", n_layers=40, d_model=2560, n_heads=20, n_kv=20,
    d_ff=6912, vocab=151936, d_head=128, qkv_bias=True,
    dtype=torch.bfloat16,
))
