"""Decoder-only LM substrate: dense and MoE transformers, in PyTorch.

Covers the five assigned LM architectures (yi-34b, qwen1.5-4b, qwen2-7b,
grok-1-314b, deepseek-moe-16b): GQA with optional QKV bias, RoPE, RMSNorm,
SwiGLU FFN, and an MoE block with shared + routed experts (top-k, grouped
sort-based dispatch with per-group capacity — no (T, E, C) dispatch tensor).

Parameters are a plain nested dict of tensors, the per-layer ones stacked
along a leading ``n_layers`` dimension:
``{"embed", "final_ln", "lm_head", "layers": {"wq", "ln1", ...}}``.
:class:`TransformerLM` holds that tree as an ``nn.Module`` whose
``named_parameters()`` are the tree's ``/``-joined paths with ``.`` for
``/`` (``layers.wq`` is ``layers/wq``), so weights, optimizer state and
checkpoints line up leaf for leaf with the reference's.

Every product is ``torch.matmul`` / ``torch.einsum``: the path has no
hand-written kernel.  Casts sit where the reference has them: RMSNorm and
RoPE compute in float32 and cast back before the weight; attention scores
are the einsum in the input dtype, then float32, masked with ``-1e30``;
the probabilities go back to the input dtype before the value einsum.

Mesh-divisibility: attention head counts are padded up to a multiple of the
tensor-parallel degree (``pad_for_mesh``; zero-initialized extra heads —
mathematically inert but they do consume FLOPs).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..dist.meta import host_int
from ..dist.sharding import (partial_sums, pick, placements,
                             reduced_lookup, summed)

Params = Dict[str, object]


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # padding for tensor parallelism (applied by pad_for_mesh)
    pad_heads_to: int = 0
    pad_kv_to: int = 0
    dtype: torch.dtype = torch.bfloat16
    # recompute each layer in the backward
    remat: bool = True
    # the reference's switch from its layer scan to a Python loop, which
    # its dry-run's cost calibration lowers (XLA's cost analysis counts a
    # scan body once).  Kept so configs carry over: the layers here always
    # run as a Python loop, so it changes nothing.
    unroll: bool = False
    # chunked online-softmax attention (flash-style): never materializes the
    # (B, H, T, T) score matrix; kv_chunk is the K/V tile length.
    flash_attention: bool = False
    kv_chunk: int = 1024
    # chunked cross-entropy: computes lm_head logits + log-softmax per
    # sequence chunk, never materializing (B, T, V) f32.
    chunked_loss: bool = False
    loss_chunk: int = 512
    # mesh axes that a DTensor activation's batch dimension is put on at
    # every layer boundary (its other dimensions replicated): the
    # reference's with_sharding_constraint, which keeps a layout with the
    # batch replicated and d_model sharded out of the layers.  Nothing
    # happens to a plain tensor.
    shard_activations: Tuple[str, ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def hq(self) -> int:
        return max(self.n_heads, self.pad_heads_to)

    @property
    def hkv(self) -> int:
        return max(self.n_kv, self.pad_kv_to)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def pad_for_mesh(self, tp: int) -> "LMConfig":
        """Pad head counts up to a multiple of the TP degree."""
        def up(x):
            return int(math.ceil(x / tp) * tp) if x % tp else x
        return dataclasses.replace(self, pad_heads_to=up(self.n_heads),
                                   pad_kv_to=up(self.n_kv))

    def n_params(self) -> int:
        """True (unpadded) parameter count."""
        d, v, l = self.d_model, self.vocab, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv * self.head_dim * 2
        if self.is_moe:
            ffn = 3 * d * self.d_ff_expert * (self.n_experts + self.n_shared) \
                + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        return l * (attn + ffn + 2 * d) + 2 * v * d + d

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared)."""
        if not self.is_moe:
            return self.n_params()
        d, l = self.d_model, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv * self.head_dim * 2
        ffn = 3 * d * self.d_ff_expert * (self.top_k + self.n_shared) \
            + d * self.n_experts
        return l * (attn + ffn + 2 * d) + 2 * self.vocab * d + d


# ------------------------------------------------------------------ params
def _layer_shapes(cfg: LMConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.head_dim
    s: Dict[str, Tuple[int, ...]] = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, cfg.hq * hd), "wk": (d, cfg.hkv * hd),
        "wv": (d, cfg.hkv * hd), "wo": (cfg.hq * hd, d),
    }
    if cfg.qkv_bias:
        s |= {"bq": (cfg.hq * hd,), "bk": (cfg.hkv * hd,),
              "bv": (cfg.hkv * hd,)}
    if cfg.is_moe:
        s |= {
            "router": (d, cfg.n_experts),
            "we1": (cfg.n_experts, d, cfg.d_ff_expert),
            "we3": (cfg.n_experts, d, cfg.d_ff_expert),
            "we2": (cfg.n_experts, cfg.d_ff_expert, d),
        }
        if cfg.n_shared:
            ds = cfg.n_shared * cfg.d_ff_expert
            s |= {"ws1": (d, ds), "ws3": (d, ds), "ws2": (ds, d)}
    else:
        s |= {"w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff), "w2": (cfg.d_ff, d)}
    return s


def param_shapes(cfg: LMConfig) -> Dict[str, object]:
    l = cfg.n_layers
    return {
        "embed": (cfg.vocab, cfg.d_model),
        "final_ln": (cfg.d_model,),
        "lm_head": (cfg.d_model, cfg.vocab),
        "layers": {k: (l, *v) for k, v in _layer_shapes(cfg).items()},
    }


def abstract_params(cfg: LMConfig) -> Params:
    """The :func:`param_shapes` tree as ``meta`` tensors of ``cfg.dtype``
    (shapes and dtypes, no storage)."""
    shapes = param_shapes(cfg)
    meta = lambda s: torch.empty(s, dtype=cfg.dtype,  # noqa: E731
                                 device="meta")
    out: Params = {k: meta(s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: meta(s) for k, s in shapes["layers"].items()}
    return out


def init_params(cfg: LMConfig, generator: torch.Generator) -> Params:
    """Random parameters, drawn from ``generator`` on its device.  The
    reference's scheme: norms at one, matrices ``N(0, 1) / sqrt(fan_in)``
    drawn in float32 and cast, biases and padded heads at zero.  The draws
    differ from the reference's (another RNG)."""
    device = generator.device

    def init_one(shape):
        if len(shape) == 1 or (len(shape) == 2 and shape[0] == cfg.n_layers):
            return torch.ones(shape, dtype=cfg.dtype, device=device)  # norms
        fan_in = shape[-2]
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.div_(math.sqrt(fan_in)).to(cfg.dtype)

    shapes = param_shapes(cfg)
    params: Params = {k: init_one(s) for k, s in sorted(shapes.items())
                      if k != "layers"}
    layers = {k: init_one(s) for k, s in sorted(shapes["layers"].items())}
    params["layers"] = layers
    # biases start at zero; padded heads stay inert because wq/wk/wv columns
    # beyond the true head count are zeroed below.
    for name in ("bq", "bk", "bv"):
        if name in layers:
            layers[name].zero_()
    hd = cfg.head_dim
    if cfg.hq > cfg.n_heads:
        layers["wq"][..., cfg.n_heads * hd:] = 0
        layers["wo"][:, cfg.n_heads * hd:, :] = 0
    if cfg.hkv > cfg.n_kv:
        for nm in ("wk", "wv"):
            layers[nm][..., cfg.n_kv * hd:] = 0
    return params


def split_layers(stacked: Dict[str, torch.Tensor]
                 ) -> List[Dict[str, torch.Tensor]]:
    """One dict per layer from the stacked ``(n_layers, ...)`` leaves.

    Each leaf is split once with ``torch.unbind``, whose backward is one
    ``stack``.  Indexing ``p[i]`` per layer instead would give every
    layer's backward a zero tensor the size of the whole leaf (at
    qwen1.5-4b, 40 x 2560 x 6912 for ``w1``: 1.4 GB in bf16 per layer)."""
    names = sorted(stacked)
    cols = [torch.unbind(stacked[n], 0) for n in names]
    return [dict(zip(names, row)) for row in zip(*cols)]


# ------------------------------------------------------------------- layers
def rmsnorm(x, w, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x, positions, theta):
    # x: (..., T, H, hd); positions: (..., T); split-halves form in float32
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs                 # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _split_heads(x, heads: int, hd: int):
    """(B, T, heads * hd) -> (B, T, heads, hd).  A DTensor whose last
    dimension a mesh dimension splits in a number of parts that does not
    divide ``heads`` (yi-34b's 8 kv heads over 16 ranks: DTensor splits a
    product's output even where the weight is replicated) is first
    replicated over that mesh dimension, so that no head is cut."""
    if isinstance(x, DTensor):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 2
              and heads % n else p
              for p, n in zip(x.placements, x.device_mesh.shape)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(x.shape[0], x.shape[1], heads, hd)


def _uneven_head_split(q, hkv: int):
    """The mesh dimensions that split a DTensor ``q``'s heads (dim 2) in a
    number of parts that does not divide ``hkv``: there its heads cannot
    be viewed as ``(hkv, group)``."""
    if not isinstance(q, DTensor):
        return []
    return [i for i, (p, n) in enumerate(zip(q.placements,
                                             q.device_mesh.shape))
            if isinstance(p, Shard) and p.dim == 2 and hkv % n]


def _kv_for_heads(q, k, v):
    """(k, v), each kv head repeated for every query head of its group
    where a DTensor ``q``'s heads are split unevenly for grouping (yi-34b:
    64 query heads over 16 ranks, 8 kv heads): the same attention, each
    query head reading its group's kv head, with a group of one, and the
    work still split by query heads.  Else ``(k, v)``."""
    hkv = k.shape[2]
    if not _uneven_head_split(q, hkv):
        return k, v
    b, tk, _, hd = k.shape
    group = q.shape[2] // hkv

    def rep(t):
        return t[:, :, :, None].expand(b, tk, hkv, group, hd).reshape(
            b, tk, hkv * group, hd)

    return rep(k), rep(v)


def _decode_attention(q, k, v, ck, cv, length: int, cfg: LMConfig):
    """One decode step's attention: (out (B, t, Hq, hd), ck, cv), the new
    keys and values written into the caches at ``length``."""
    b, t, _, hd = q.shape
    tk = ck.shape[1]
    # the write clamps its start so the update fits, as XLA's
    # dynamic_update_slice does; the masks use the unclamped length
    start = min(max(length, 0), tk - t)
    ck = torch.cat([ck[:, :start], k, ck[:, start + t:]], 1)
    cv = torch.cat([cv[:, :start], v, cv[:, start + t:]], 1)
    kpos = torch.arange(tk, device=q.device)
    # mask out positions beyond current length + t, and the future
    scores_mask = kpos < (length + t)
    group = cfg.hq // cfg.hkv
    qg = _heads_grouped(q, cfg.hkv).reshape(b, t, cfg.hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck).float()
    scores = scores / math.sqrt(hd)
    qpos = torch.arange(t, device=q.device)[:, None] + length
    causal = qpos >= kpos[None, :]
    scores = torch.where((causal & scores_mask[None, :])[None, None, None],
                         scores, -1e30)
    probs = torch.softmax(scores, -1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv).reshape(
        b, t, cfg.hq, hd)
    return out, ck, cv


def _by_blocks(cache) -> bool:
    """Whether a DTensor cache is split only by batch rows (dim 0) and kv
    heads (dim 2), whole in the sequence."""
    return all(not isinstance(p, Shard) or p.dim in (0, 2)
               for p in cache.placements) and not any(
        p.is_partial() for p in cache.placements)


def _decode_per_block(q, k, v, ck, cv, length: int, cfg: LMConfig):
    """:func:`_decode_attention` on DTensors, run by each rank on its own
    block of batch rows and kv heads, the caches' own (a step reads and
    writes only its block; GSPMD partitions it so): ``q``, ``k``, ``v``
    placed as the caches are, each kv head's query heads with it."""
    mesh, pl = ck.device_mesh, ck.placements
    q, k, v = (x.redistribute(mesh, pl) for x in (q, k, v))
    local = dataclasses.replace(
        cfg, pad_heads_to=q.to_local().shape[2],
        pad_kv_to=ck.to_local().shape[2], n_heads=1, n_kv=1)
    out, lk, lv = _decode_attention(q.to_local(), k.to_local(),
                                    v.to_local(), ck.to_local(),
                                    cv.to_local(), length, local)
    wrap = lambda t, like: DTensor.from_local(  # noqa: E731
        t.contiguous(), mesh, pl, run_check=False, shape=like.shape,
        stride=like.stride())
    return wrap(out, q), wrap(lk, ck), wrap(lv, cv)


def _per_block(fn, q, k, v):
    """``fn(q, k, v)`` (causal attention, plain or flash) on DTensors, run
    by each rank on its own block of batch rows and heads: attention is
    independent across both, and GSPMD partitions it so, with no
    communication.  DTensor's own einsum would merge the batch and heads
    dimensions, split over different mesh dimensions, into one strided
    layout, whose redistribution plans DTensor searches for at a cost that
    grows past any budget on a three-axis mesh.  Every mesh dimension is
    made to split the batch (dim 0) or the heads (dim 2) or to replicate,
    and ``k``, ``v`` are placed as ``q``."""
    mesh = q.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local()).contiguous()
    b, t, h, hd = q.shape
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=q.shape,
                              stride=(t * h * hd, h * hd, hd, 1))


def _heads_grouped(q, hkv: int):
    """``q`` with its heads replicated over the mesh dimensions that split
    them unevenly for grouping (decode: a one-token ``q``, far smaller
    than the cache it reads), so that they view as ``(hkv, group)``."""
    dims = _uneven_head_split(q, hkv)
    if not dims:
        return q
    return q.redistribute(q.device_mesh, [
        Replicate() if i in dims else p for i, p in enumerate(q.placements)])


def _flash_chunk(acc, m, denom, qg, kb, vb, kpos, qpos):
    """One K/V chunk of the online softmax: the new (acc, max, denom)."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb).float()
    s = s / math.sqrt(qg.shape[-1])
    mask = qpos[:, None] >= kpos[None, :]                   # (tq, kv_chunk)
    s = torch.where(mask[None, :, None, None, :], s, -1e30)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    acc = acc * alpha[..., None] + torch.einsum(
        "bqhgk,bkhd->bqhgd", p.to(qg.dtype), vb).float()
    denom = denom * alpha + p.sum(-1)
    return acc, m_new, denom


def _flash_attention(q, k, v, *, kv_chunk: int):
    """Causal online-softmax attention over K/V chunks (flash-style).

    Streams the K/V with a running (max, denom) instead of materializing
    the (B, Hkv, G, T, T) scores.  Same math (exact softmax, f32
    accumulation).  Each chunk is recomputed in the backward, as the
    reference checkpoints its body: otherwise autograd keeps every
    chunk's (b, tq, h, g, kv_chunk) probabilities, most of the memory
    this form removes.
    """
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, tq, hkv, group, hd)
    qpos = torch.arange(tq, device=q.device)
    acc = torch.zeros((b, tq, hkv, group, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, tq, hkv, group), -1e30, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((b, tq, hkv, group), dtype=torch.float32,
                        device=q.device)
    for c0 in range(0, tk, kv_chunk):
        args = (acc, m, denom, qg, k[:, c0:c0 + kv_chunk],
                v[:, c0:c0 + kv_chunk],
                torch.arange(c0, c0 + kv_chunk, device=q.device), qpos)
        if torch.is_grad_enabled():
            acc, m, denom = checkpoint(_flash_chunk, *args,
                                       use_reentrant=False)
        else:
            acc, m, denom = _flash_chunk(*args)
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(b, tq, hq, hd)


def _attention(q, k, v, *, causal: bool, q_offset: int = 0):
    # q: (B, Tq, Hq, hd); k/v: (B, Tk, Hkv, hd); GQA via head grouping.
    # Not F.scaled_dot_product_attention: its masking and accumulation are
    # another function's.
    b, tq, hq, hd = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, tq, hkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(hd)
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        mask = qpos >= torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, -1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, tq, hq, hd)


def attention_block(x, layer, cfg: LMConfig, positions, cache=None):
    """Returns (attn_out, new_cache_entry).  cache: (k, v, length) with k/v
    (B, T_max, Hkv, hd) and ``length`` an int (decode path)."""
    b, t, d = x.shape
    hd = cfg.head_dim
    q = x @ layer["wq"]
    k = x @ layer["wk"]
    v = x @ layer["wv"]
    if cfg.qkv_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = _split_heads(q, cfg.hq, hd)
    k = _split_heads(k, cfg.hkv, hd)
    v = _split_heads(v, cfg.hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        if cfg.flash_attention and t % cfg.kv_chunk == 0 and t > cfg.kv_chunk:
            fn = partial(_flash_attention, kv_chunk=cfg.kv_chunk)
        else:
            fn = partial(_attention, causal=True)
        if isinstance(q, DTensor):
            out = _per_block(fn, q, *_kv_for_heads(q, k, v))
        else:
            out = fn(q, k, v)
        new_cache = (k, v)
    else:
        ck, cv, length = cache                    # (B, Tmax, Hkv, hd) x2, int
        if isinstance(ck, DTensor) and _by_blocks(ck):
            out, ck, cv = _decode_per_block(q, k, v, ck, cv, length, cfg)
        else:
            out, ck, cv = _decode_attention(q, k, v, ck, cv, length, cfg)
        new_cache = (ck, cv)
    return out.reshape(b, t, cfg.hq * hd) @ layer["wo"], new_cache


def dense_ffn(x, layer):
    return (F.silu(x @ layer["w1"]) * (x @ layer["w3"])) @ layer["w2"]


def moe_dispatch(sel: torch.Tensor, n_experts: int, cap: int):
    """Sort-based dispatch of each row's ``(T, k)`` expert choices.

    Per row (a dispatch group): the T·k choices sorted by expert, stably;
    each one's rank within its expert (``searchsorted`` on the left); a
    choice ranked at or past ``cap`` is dropped into the waste slot
    ``n_experts * cap``.  Returns ``(stok, slot, keep, order)``, each
    ``(B, T·k)``: the token of each sorted choice, its buffer slot,
    whether it was kept, and the sort's permutation."""
    b, t, k = sel.shape
    flat_e = sel.reshape(b, t * k)
    tok = torch.arange(t * k, device=sel.device) // k
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    stok = tok[order]
    start = torch.searchsorted(se.contiguous(), se.contiguous(), side="left")
    pos = torch.arange(t * k, device=sel.device) - start     # rank in expert
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos,
                       torch.full_like(se, n_experts * cap))
    return stok, slot, keep, order


def moe_ffn(x, layer, cfg: LMConfig):
    """Shared experts + routed top-k with grouped sort-based dispatch.

    x: (B, T, d) — each (batch) row is a dispatch group, so the sort and the
    capacity ``ceil(T·k / E · capacity_factor)`` are local to the row.
    Choices beyond capacity are dropped exactly as the reference drops
    them.  The reference's ``vmap`` over rows becomes flat row offsets
    into one ``index_add``.
    """
    if isinstance(x, DTensor):
        y = _routed_per_block(x, layer, cfg)
    else:
        y = _routed(x, layer["router"], layer["we1"], layer["we3"],
                    layer["we2"], cfg)
    if cfg.n_shared:
        y = y + (F.silu(x @ layer["ws1"]) * (x @ layer["ws3"])) @ layer["ws2"]
    return y


def _routed(x, router, we1, we3, we2, cfg: LMConfig):
    """The routed experts' output of :func:`moe_ffn` on plain tensors."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(t * k / e * cfg.capacity_factor))

    logits = (x @ router).float()                            # (B, T, E)
    gate, sel = torch.topk(logits, k, dim=-1)                # (B, T, k)
    gate = torch.softmax(gate, -1).to(x.dtype)
    stok, slot, keep, order = moe_dispatch(sel, e, cap)
    sg = torch.gather(gate.reshape(b, t * k), 1, order)
    rows = torch.arange(b, device=x.device)[:, None]

    xs = x[rows, stok]                                       # (B, T·k, d)
    xs = torch.where(keep[..., None], xs, torch.zeros_like(xs))
    n_slot = e * cap + 1                                     # + waste slot
    buf = x.new_zeros(b * n_slot, d).index_add(
        0, (rows * n_slot + slot).reshape(-1), xs.reshape(-1, d))
    h_in = buf.reshape(b, n_slot, d)[:, :e * cap].reshape(b, e, cap, d)
    h = torch.einsum("becd,edf->becf", h_in, we1)
    h3 = torch.einsum("becd,edf->becf", h_in, we3)
    h = F.silu(h) * h3
    out_e = torch.einsum("becf,efd->becd", h, we2).reshape(b, e * cap, d)
    back = out_e[rows, torch.clamp(slot, 0, e * cap - 1)] * sg[..., None]
    back = torch.where(keep[..., None], back, torch.zeros_like(back))
    return x.new_zeros(b * t, d).index_add(
        0, (rows * t + stok).reshape(-1), back.reshape(-1, d)).reshape(b, t, d)


def _routed_per_block(x, layer, cfg: LMConfig):
    """:func:`_routed` on DTensors, as GSPMD partitions the reference's
    ``vmap`` over dispatch groups: each rank routes its own batch rows
    (the dispatch's sort and ``searchsorted`` have no DTensor rule, and a
    row's dispatch needs nothing of another row) through its ``model``
    slice of every expert's ``d_ff_expert``; the router and the experts'
    other dimensions are gathered, and the slices' partial sums stay
    partial over ``model`` until an operation needs them summed.  The
    gradients of what a rank reads are its share of a sum: over the batch
    rows for the weights, over the slices for the rows and the router."""
    mesh = x.device_mesh
    model = [i for i, n in enumerate(mesh.mesh_dim_names) if n == "model"]
    rows = [p if isinstance(p, Shard) and p.dim == 0 and i not in model
            else Replicate() for i, p in enumerate(x.placements)]
    summed = [Partial() if i in model else p for i, p in enumerate(rows)]

    def local(name, ff_dim=None):
        pl = [Shard(ff_dim) if ff_dim is not None and i in model
              else Replicate() for i in range(mesh.ndim)]
        grad = [p if isinstance(p, Shard) else Partial() for p in pl]
        return layer[name].redistribute(mesh, pl).to_local(
            grad_placements=grad)

    y = _routed(x.redistribute(mesh, rows).to_local(grad_placements=summed),
                local("router"), local("we1", 2), local("we3", 2),
                local("we2", 1), cfg)
    return partial_sums(y, mesh, summed, x.shape)


def _constrain(x, cfg: LMConfig):
    """``x`` with its batch dimension on ``cfg.shard_activations`` and
    its other dimensions replicated, where ``x`` is a DTensor and the
    option is set; else ``x``."""
    if not cfg.shard_activations or not isinstance(x, DTensor):
        return x
    spec = (tuple(cfg.shard_activations),) + (None,) * (x.dim() - 1)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def _layer_fn(x, layer, cfg: LMConfig, positions, cache=None):
    x = _constrain(x, cfg)
    h, new_cache = attention_block(rmsnorm(x, layer["ln1"], cfg.norm_eps),
                                   layer, cfg, positions, cache)
    x = x + _onto(h, x)
    xn = rmsnorm(x, layer["ln2"], cfg.norm_eps)
    f = moe_ffn(xn, layer, cfg) if cfg.is_moe else dense_ffn(xn, layer)
    x = x + _onto(f, x)
    return _constrain(x, cfg), new_cache


def _onto(h, x):
    """A block's output ``h`` placed as the residual stream ``x`` where
    both are DTensors (a row-parallel product's partial sums all-reduced,
    as Megatron's tensor parallelism does: ``dist.sharding.summed``); else
    ``h``.  Left to itself DTensor reduce-scatters them onto the sequence
    dimension, and the next product, flattening batch and sequence split
    over different mesh axes, makes a strided layout whose
    redistributions DTensor plans by a search that does not finish on a
    three-axis mesh."""
    if isinstance(h, DTensor) and isinstance(x, DTensor) \
            and h.placements != x.placements:
        return summed(h, x.placements)
    return h


def _train_layer(x, layer, cfg: LMConfig, positions):
    return _layer_fn(x, layer, cfg, positions)[0]


# ------------------------------------------------------------------ forward
def _embed(tokens, embed, cfg: LMConfig):
    """The tokens' embedding rows in ``cfg.dtype`` (from a DTensor table
    split over the vocabulary, reduced once: ``dist.reduced_lookup``)."""
    return reduced_lookup(F.embedding(tokens, embed)).to(cfg.dtype)


def forward_hidden(params, tokens, cfg: LMConfig):
    """Transformer trunk without the LM head: (B, T) -> (B, T, d).

    With ``remat`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant)."""
    x = _embed(tokens, params["embed"], cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device
                             ).expand(tokens.shape)
    for layer in split_layers(params["layers"]):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_train_layer, x, layer, cfg, positions,
                           use_reentrant=False)
        else:
            x = _train_layer(x, layer, cfg, positions)
    return rmsnorm(x, params["final_ln"], cfg.norm_eps)


def forward(params, tokens, cfg: LMConfig):
    """tokens (B, T) -> logits (B, T, vocab) in float32.  Training/prefill
    path."""
    return (forward_hidden(params, tokens, cfg) @ params["lm_head"]).float()


def _ce_chunk(h, lm_head, labels, mask):
    logits = (h @ lm_head).float()
    if isinstance(logits, DTensor):
        nll = _split_vocab_nll(logits, labels)
    else:
        logp = torch.log_softmax(logits, -1)
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return (nll * mask).sum()


def _split_vocab_nll(logits: DTensor, labels) -> DTensor:
    """``-log_softmax(logits)[label]`` of DTensor logits whose vocabulary
    stays split as the vocab-sharded head leaves it: the log-sum-exp's max
    and sum, and the label's logit (``dist.sharding.pick``), are
    reductions over the split dimension (DTensor sums the shards' partial
    results), as GSPMD partitions them; DTensor's own ``log_softmax``
    would gather the whole vocabulary on every rank.  The max is a
    constant of the function (it shifts every logit alike), so it takes
    no gradient."""
    z = logits - logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(z).sum(-1))
    return lse - pick(z, labels)


def _chunked_ce(hidden, lm_head, labels, mask, chunk: int):
    """Streams T-chunks through lm_head + log-softmax so that only a
    (B, chunk, V) float32 block is alive; the backward recomputes each
    chunk."""
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        args = (hidden[:, c0:c0 + chunk], lm_head, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            total = total + _ce_chunk(*args)
    return total


def loss_fn(params, batch, cfg: LMConfig):
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    if cfg.chunked_loss and labels.shape[1] % cfg.loss_chunk == 0 \
            and labels.shape[1] > cfg.loss_chunk:
        hidden = forward_hidden(params, batch["tokens"], cfg)
        total = _chunked_ce(hidden, params["lm_head"], labels, mask,
                            cfg.loss_chunk)
        return total / denom
    return _ce_chunk(forward_hidden(params, batch["tokens"], cfg),
                     params["lm_head"], labels, mask) / denom


# ------------------------------------------------------------------- decode
def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    shape = (cfg.n_layers, batch, max_len, cfg.hkv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params, cache, tokens, cfg: LMConfig):
    """One decode step: tokens (B, t) + cache -> (logits (B, t, V), cache)."""
    b, t = tokens.shape
    # traced on meta tensors, any length: the step's work does not
    # depend on it
    length = host_int(cache["length"], 0)
    x = _embed(tokens, params["embed"], cfg)
    positions = (torch.arange(t, device=tokens.device)[None]
                 + length).expand(b, t)
    nks, nvs = [], []
    for layer, ck, cv in zip(split_layers(params["layers"]),
                             cache["k"].unbind(0), cache["v"].unbind(0)):
        x, (nk, nv) = _layer_fn(x, layer, cfg, positions,
                                cache=(ck, cv, length))
        nks.append(nk)
        nvs.append(nv)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, {"k": torch.stack(nks), "v": torch.stack(nvs),
                    "length": cache["length"] + t}


# ------------------------------------------------------------------- module
class TransformerLM(nn.Module):
    """The LM as a module over the functions above.

    ``TransformerLM(cfg, params)`` wraps an existing tree (its tensors
    become the module's parameters, storage shared);
    ``TransformerLM(cfg, generator=g)`` draws one with :func:`init_params`
    on ``g``'s device.  ``params`` gives the tree back, as ``nn.Parameter``
    leaves that require grad, for the functional API and the optimizer."""

    def __init__(self, cfg: LMConfig, params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if params is None:
            if generator is None:
                raise ValueError("TransformerLM needs params or a generator")
            params = init_params(cfg, generator)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.final_ln = nn.Parameter(params["final_ln"])
        self.lm_head = nn.Parameter(params["lm_head"])
        self.layers = nn.ParameterDict(
            {k: nn.Parameter(params["layers"][k])
             for k in sorted(params["layers"])})

    @property
    def params(self) -> Params:
        return {"embed": self.embed, "final_ln": self.final_ln,
                "lm_head": self.lm_head, "layers": dict(self.layers.items())}

    def forward(self, tokens):
        return forward(self.params, tokens, self.cfg)
