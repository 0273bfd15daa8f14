"""Architecture config framework: one object per assigned architecture
(the LM family).

Every arch exposes:

* ``shapes``         — the assigned (shape_name → params) cells;
* ``smoke_*``        — a REDUCED same-family config + one real forward/train
                       step (tests and ``launch.train --scale smoke``);
* ``model_flops``    — the analytic MODEL_FLOPS (6·N·D dense /
                       6·N_active·D MoE for training).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import numpy as np
import torch

from ..models import transformer as tf_mod
from ..torchgm.frontier import resolve
from ..train import optimizer as opt_mod

OPT = opt_mod.AdamWConfig()


class ArchConfig:
    arch_id: str = ""
    family: str = ""
    shapes: Dict[str, Dict[str, Any]] = {}

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Run one reduced forward/train step; return metrics for asserts."""
        raise NotImplementedError

    def model_flops(self, shape) -> float:
        raise NotImplementedError


# ===================================================================== LM ===
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


class LMArch(ArchConfig):
    family = "lm"
    shapes = LM_SHAPES

    def __init__(self, cfg: tf_mod.LMConfig):
        self.cfg = cfg
        self.arch_id = cfg.name

    # ------------------------------------------------------------ smoke
    def smoke_config(self) -> tf_mod.LMConfig:
        c = self.cfg
        return dataclasses.replace(
            c, n_layers=2, d_model=64, n_heads=4, n_kv=max(1, min(c.n_kv, 2)),
            d_ff=128, vocab=256, d_head=16,
            n_experts=min(c.n_experts, 4), top_k=min(c.top_k, 2),
            n_shared=min(c.n_shared, 1),
            d_ff_expert=64 if c.n_experts else 0,
            dtype=torch.float32, pad_heads_to=0, pad_kv_to=0)

    def smoke(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """One reduced train step and a decode step, on ``device`` (the
        card unless the CPU is asked for)."""
        device = resolve(device)
        cfg = self.smoke_config()
        gen = torch.Generator(device).manual_seed(seed)
        params = tf_mod.TransformerLM(cfg, generator=gen).params
        rng = np.random.default_rng(seed)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                                    dtype=torch.int32, device=device)
                 for k in ("tokens", "labels")}
        step = opt_mod.make_train_step(
            lambda p, b: tf_mod.loss_fn(p, b, cfg), OPT)
        with torch.no_grad():
            logits = tf_mod.forward(params, batch["tokens"], cfg)
            cache = tf_mod.init_cache(cfg, 2, 32, device)
            dec_logits, cache = tf_mod.decode_step(
                params, cache, batch["tokens"][:, :1], cfg)
        params, _, m = step(params, opt_mod.init_state(params), batch)
        return {"loss": float(m["loss"]),
                "logits_shape": tuple(logits.shape),
                "decode_shape": tuple(dec_logits.shape),
                "grad_norm": float(m["grad_norm"]),
                "finite": bool(torch.isfinite(m["loss"]))
                and bool(torch.isfinite(m["grad_norm"]))}

    def model_flops(self, shape: Union[str, Dict[str, Any]]) -> float:
        """``shape``: a name of ``shapes`` or a dict of the same keys
        (``kind``, ``seq_len``, ``global_batch``)."""
        sp = self.shapes[shape] if isinstance(shape, str) else shape
        n_active = self.cfg.n_active_params()
        if sp["kind"] == "train":
            tokens = sp["seq_len"] * sp["global_batch"]
            return 6.0 * n_active * tokens
        if sp["kind"] == "prefill":
            tokens = sp["seq_len"] * sp["global_batch"]
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention over the cache
        c = self.cfg
        attn = (2 * 2 * c.n_layers * sp["seq_len"] * c.n_kv * c.head_dim
                * (c.n_heads // c.n_kv))
        return sp["global_batch"] * (2.0 * n_active + attn)
