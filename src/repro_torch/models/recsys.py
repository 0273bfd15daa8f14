"""DIN (Deep Interest Network) recsys substrate [arXiv:1706.06978].

Huge sparse embedding tables → target attention over the user-behaviour
sequence → small MLP.  Lookups are ``F.embedding`` (a gather) with the
bag reductions written out, as the reference writes them over
``jnp.take``; their gradients are dense, as the reference's are, so
AdamW decays and moves every row of a table.  ``retrieval_scores`` scores
a flat candidate set with one batched attention + MLP, never a loop.

Parameters are a flat dict of tensors with the reference's keys
(``item_table``, ``attn_w0``, ``mlp_b2``, ...); :class:`DIN` holds it as
an ``nn.Module`` whose ``named_parameters()`` are those keys.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..dist.sharding import reduced_lookup

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DINConfig:
    name: str
    embed_dim: int = 18
    seq_len: int = 100
    n_items: int = 1_000_000
    n_cates: int = 10_000
    n_user_feats: int = 8            # small profile fields
    user_feat_vocab: int = 1_000
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    dtype: torch.dtype = torch.float32


def param_shapes(cfg: DINConfig) -> Dict[str, Any]:
    d = cfg.embed_dim
    pair = 2 * d                     # item ⊕ cate embedding
    s: Dict[str, Any] = {
        "item_table": (cfg.n_items, d),
        "cate_table": (cfg.n_cates, d),
        "user_table": (cfg.user_feat_vocab, d),
    }
    # attention MLP over [hist, target, hist*target, hist-target]
    dims = (4 * pair,) + tuple(cfg.attn_mlp) + (1,)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        s[f"attn_w{i}"] = (a, b)
        s[f"attn_b{i}"] = (b,)
    # final MLP over [user_profile, interest, target, interest*target]
    d_in = cfg.n_user_feats * d + 3 * pair
    dims = (d_in,) + tuple(cfg.mlp) + (1,)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        s[f"mlp_w{i}"] = (a, b)
        s[f"mlp_b{i}"] = (b,)
    return s


def abstract_params(cfg: DINConfig) -> Params:
    """The :func:`param_shapes` dict as ``meta`` tensors of ``cfg.dtype``
    (shapes and dtypes, no storage)."""
    return {k: torch.empty(s, dtype=cfg.dtype, device="meta")
            for k, s in param_shapes(cfg).items()}


def init_params(cfg: DINConfig, generator: torch.Generator) -> Params:
    """Random parameters on ``generator``'s device, drawn in sorted key
    order.  The reference's scheme: 1-D leaves at zero, matrices
    ``N(0, 1)`` times 0.01 where the first dimension is above 10,000 rows,
    else times ``1 / sqrt(rows)``, drawn in float32 and cast.  The draws
    differ from the reference's (another RNG)."""
    device = generator.device

    def one(s):
        if len(s) == 1:
            return torch.zeros(s, dtype=cfg.dtype, device=device)
        scale = 0.01 if s[0] > 10_000 else 1.0 / math.sqrt(s[0])
        w = torch.randn(s, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(cfg.dtype)

    shapes = param_shapes(cfg)
    return {k: one(shapes[k]) for k in sorted(shapes)}


# -------------------------------------------------------------- embedding
def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  combine: str = "none") -> torch.Tensor:
    """EmbeddingBag built from gather + reduce (dense gradient).

    ids (..., L) -> (..., L, d) or reduced (..., d) for combine=sum/mean.
    """
    e = reduced_lookup(F.embedding(ids, table))
    if mask is not None:
        e = e * mask[..., None].to(e.dtype)
    if combine == "sum":
        return e.sum(dim=-2)
    if combine == "mean":
        denom = (mask.sum(-1, keepdim=True) if mask is not None
                 else torch.full(e.shape[:-2] + (1,), e.shape[-2],
                                 dtype=e.dtype, device=e.device))
        return e.sum(dim=-2) / torch.clamp(denom, min=1.0)
    return e


def _mlp(p, prefix, x, n, act=torch.sigmoid):
    for i in range(n):
        x = x @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        if i < n - 1:
            x = act(x)
    return x


def _n_layers(p, prefix):
    return len([k for k in p if k.startswith(f"{prefix}_w")])


def attention_scores(p, hist: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """hist (..., L, 2d) · target (..., 2d) -> scores (..., L) from
    MLP([h, t, h*t, h-t])."""
    t = target[..., None, :].expand(hist.shape)
    feats = torch.cat([hist, t, hist * t, hist - t], dim=-1)
    return _mlp(p, "attn", feats, _n_layers(p, "attn"))[..., 0]


def target_attention(p, hist: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """DIN local activation unit.

    hist (..., L, 2d) · target (..., 2d) -> interest (..., 2d).
    Masked positions of :func:`attention_scores` get ``-1e30`` before a
    float32 softmax (cast back to ``hist``'s dtype) and zero after it.
    """
    scores = attention_scores(p, hist, target)
    keep = mask > 0
    scores = torch.where(keep, scores, -1e30)
    w = torch.softmax(scores.float(), dim=-1).to(hist.dtype)
    w = torch.where(keep, w, 0.0)
    return torch.einsum("...l,...ld->...d", w, hist)


def _pair(p, items, cates):
    return torch.cat([embedding_bag(p["item_table"], items),
                      embedding_bag(p["cate_table"], cates)], dim=-1)


def forward(params, batch, cfg: DINConfig):
    """batch: item_id (B,), cate_id (B,), hist_items (B, L), hist_cates
    (B, L), hist_mask (B, L), user_feats (B, n_user_feats) -> logits (B,)."""
    p = params
    tgt = _pair(p, batch["item_id"], batch["cate_id"])        # (B, 2d)
    hist = _pair(p, batch["hist_items"], batch["hist_cates"])  # (B, L, 2d)
    interest = target_attention(p, hist, tgt, batch["hist_mask"])
    user = embedding_bag(p["user_table"], batch["user_feats"])  # (B, U, d)
    user = user.reshape(user.shape[0], -1)
    x = torch.cat([user, interest, tgt, interest * tgt], dim=-1)
    return _mlp(p, "mlp", x, _n_layers(p, "mlp"))[:, 0]


def loss_fn(params, batch, cfg: DINConfig):
    logits = forward(params, batch, cfg)
    y = batch["label"].float()
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    relu = torch.maximum(logits, logits.new_zeros(()))
    return torch.mean(relu - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def retrieval_scores(params, batch, cfg: DINConfig):
    """Score one user against a flat candidate set (retrieval_cand shape).

    batch: hist_items/hist_cates/hist_mask (1, L), user_feats (1, U),
    cand_items (C,), cand_cates (C,) -> scores (C,).
    One batched attention+MLP over all candidates — no loop.
    """
    p = params
    hist = _pair(p, batch["hist_items"], batch["hist_cates"])[0]   # (L, 2d)
    cand = _pair(p, batch["cand_items"], batch["cand_cates"])      # (C, 2d)
    user = embedding_bag(p["user_table"], batch["user_feats"])[0].reshape(-1)
    if isinstance(cand, DTensor):
        return _scores_per_block(p, hist, cand, user, batch["hist_mask"][0])
    return _scores(p, hist, cand, user, batch["hist_mask"][0])


def _scores(p, hist, cand, user, hist_mask):
    """The scores of candidates ``cand`` (C, 2d) for one user's ``hist``
    (L, 2d), ``user`` features and ``hist_mask`` (L,) -> (C,)."""
    c = cand.shape[0]
    mask = hist_mask[None, :].expand(c, hist.shape[0])
    hist_b = hist[None].expand((c,) + tuple(hist.shape))
    interest = target_attention(p, hist_b, cand, mask)            # (C, 2d)
    user_b = user[None].expand(c, user.shape[0])
    x = torch.cat([user_b, interest, cand, interest * cand], dim=-1)
    return _mlp(p, "mlp", x, _n_layers(p, "mlp"))[:, 0]


def _scores_per_block(p, hist, cand: DTensor, user, hist_mask) -> DTensor:
    """:func:`_scores` on DTensors, run by each rank on its own block of
    candidates, which are independent (GSPMD partitions it so, with no
    communication): the MLPs, the user and the history are replicated.
    DTensor's own products would flatten the (C, L, .) features, which it
    refuses where the candidates split unevenly over the ranks."""
    if any(not isinstance(pl, (Shard, Replicate))
           or (isinstance(pl, Shard) and pl.dim != 0)
           for pl in cand.placements):
        raise ValueError(f"candidates placed as {cand.placements}: "
                         f"expected a split of their rows or replicas")
    whole = {k: v.full_tensor() for k, v in p.items()
             if not k.endswith("_table")}
    out = _scores(whole, hist.full_tensor(), cand.to_local(),
                  user.full_tensor(), hist_mask.full_tensor())
    return DTensor.from_local(out.contiguous(), cand.device_mesh,
                              cand.placements, run_check=False,
                              shape=cand.shape[:1], stride=(1,))


def attention_grad_scales(params, batch, cfg: DINConfig) -> Dict[str, float]:
    """{attn_* leaf: the largest entry of the loss's gradient with respect
    to it, taken with the scores' gradient in absolute value}.

    The scores' gradient sums to zero over each history (the softmax is
    shift-invariant), so an attn_* leaf's gradient is a sum of terms that
    cancel (the last bias's exactly).  This is the size of those terms:
    the yardstick against which a check holds those gradients' rounding.
    The scores' gradient is the loss's gradient with respect to a last
    attention bias that has one entry per score."""
    attn = {k: v.detach().requires_grad_(True) for k, v in params.items()
            if k.startswith("attn_")}
    last = f"attn_b{_n_layers(params, 'attn') - 1}"
    shape = tuple(batch["hist_mask"].shape) + (1,)
    bias = attn[last].detach().expand(shape).clone().requires_grad_(True)
    (d_scores,) = torch.autograd.grad(
        loss_fn({**params, last: bias}, batch, cfg), bias)
    p = {**params, **attn}
    tgt = _pair(p, batch["item_id"], batch["cate_id"]).detach()
    hist = _pair(p, batch["hist_items"], batch["hist_cates"]).detach()
    keys = sorted(attn)
    grads = torch.autograd.grad(attention_scores(p, hist, tgt),
                                [attn[k] for k in keys],
                                grad_outputs=d_scores[..., 0].abs())
    return {k: float(g.abs().max()) for k, g in zip(keys, grads)}


class DIN(nn.Module):
    """DIN as a module over the functions above.

    ``DIN(cfg, params)`` wraps an existing tree (storage shared);
    ``DIN(cfg, generator=g)`` draws one with :func:`init_params` on
    ``g``'s device.  ``params`` gives the flat tree back, as
    ``nn.Parameter`` leaves that require grad."""

    def __init__(self, cfg: DINConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if params is None:
            if generator is None:
                raise ValueError("DIN needs params or a generator")
            params = init_params(cfg, generator)
        self.cfg = cfg
        self._keys = sorted(params)
        for k in self._keys:
            self.register_parameter(k, nn.Parameter(params[k]))

    @property
    def params(self) -> Params:
        return {k: getattr(self, k) for k in self._keys}

    def forward(self, batch):
        return forward(self.params, batch, self.cfg)
