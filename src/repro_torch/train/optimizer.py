"""AdamW + LR schedules + gradient clipping, from scratch (no torch.optim).

State is a plain tree ``{"step", "m", "v"}`` mirroring the params tree, so
it checkpoints with the same machinery as params and lines up leaf for
leaf with the reference's state.

``apply_updates`` updates ``p``, ``m`` and ``v`` in place, a slice of at
most ``SLICE_ELEMS`` elements at a time (a few layers of a stacked leaf,
or a block of rows of the embedding).  The reference's update is out of
place: at qwen1.5-4b it would hold about eight float32 temporaries of the
largest leaf (708 M elements, 2.8 GB each) beside 47.4 GB of state; here
the temporaries are those of one slice.  The values are the reference's:
the update runs in float32 with the bias corrections ``1 - b^step`` in
float32, and the result is cast back to the parameter's dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from . import tree as tr

# elements of one in-place update slice (64 MB of float32 temporaries each)
SLICE_ELEMS = 1 << 24


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | constant
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * t
    else:
        decay = torch.ones((), device=step.device)
    return cfg.lr * warm * decay


def init_state(params) -> Dict[str, Any]:
    first = tr.leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "m": tr.map_tree(zeros, params), "v": tr.map_tree(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in tr.leaves(tree)))


def _slices(t: torch.Tensor):
    """Views of ``t`` along its first dimension, each at most
    ``SLICE_ELEMS`` elements (at least one row)."""
    if t.dim() == 0:
        return (t.view(1),)
    row = max(1, t[0].numel())
    return t.split(max(1, SLICE_ELEMS // row), 0)


def _reduced(g: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient with its partial sums added up (replicated over
    those mesh dimensions), as a single device's gradient is, before the
    update scales it: scaling each rank's partial term first would round
    them apart where they cancel."""
    if isinstance(g, DTensor) and any(p.is_partial() for p in g.placements):
        return g.redistribute(g.device_mesh, [
            Replicate() if p.is_partial() else p for p in g.placements])
    return g


def _split_copies(t: torch.Tensor) -> bool:
    """Whether ``t`` splits along its first dimension into copies, not
    views: a DTensor whose placements shard that dimension."""
    return isinstance(t, DTensor) and any(
        isinstance(p, Shard) and p.dim == 0 for p in t.placements)


def _sliced(*ts):
    """The matching slices of same-shaped leaves (:func:`_slices`), or the
    leaves whole where one of them would split into copies, whose update
    would be lost."""
    if any(_split_copies(t) for t in ts):
        return (ts,)
    return zip(*(_slices(t) for t in ts))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig,
                  decay_mask: Optional[Any] = None):
    """Returns (params, new_state, metrics); ``params`` and the state's
    ``m`` and ``v`` are updated in place."""
    step = state["step"] + 1
    grads = tr.map_tree(_reduced, grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v, wd_on):
        g = g.float() * scale
        m.mul_(b1).add_(g.mul(1 - b1))
        v.mul_(b2).add_(g.square().mul_(1 - b2))
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if cfg.weight_decay:
            delta.add_(p.float() * (cfg.weight_decay * wd_on))
        p.copy_((p.float() - lr * delta).to(p.dtype))

    if decay_mask is None:
        # default: decay leaves of rank >= 2.  The per-layer leaves are
        # stacked, so this decays the norms (L, d) and the biases (L, h·hd)
        # as well — the reference's rule, kept as it is.
        decay_mask = tr.map_tree(lambda p: float(p.ndim >= 2), params)
    for p, g, m, v, d in zip(tr.leaves(params), tr.leaves(grads),
                             tr.leaves(state["m"]), tr.leaves(state["v"]),
                             tr.leaves(decay_mask)):
        for sl in _sliced(p, g, m, v):
            upd(*sl, d)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, \
        {"lr": lr, "grad_norm": gnorm}


def make_train_step(loss_fn: Callable, cfg: AdamWConfig,
                    compressor=None) -> Callable:
    """Generic train step: (params, opt_state, batch) -> (params, state,
    metrics).  ``params`` is a tree of leaf tensors that require grad
    (``TransformerLM.params``); one forward and backward
    (``torch.autograd.grad``) gives the loss and the gradients; a leaf the
    loss does not use (graphcast's ``m2g_node``) gets a zero gradient, as
    ``jax.grad`` gives it.
    ``compressor`` optionally transforms grads (e.g. int8
    quantize/dequantize with error feedback — see train.compression)."""

    def step(params, opt_state, batch, comp_state=None):
        loss = loss_fn(params, batch)
        grads = tr.unflatten_like(
            params, torch.autograd.grad(loss, tr.leaves(params),
                                        materialize_grads=True))
        if compressor is not None:
            grads, comp_state = compressor(grads, comp_state)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   cfg)
        metrics["loss"] = loss.detach()
        if compressor is not None:
            return params, opt_state, comp_state, metrics
        return params, opt_state, metrics

    return step
