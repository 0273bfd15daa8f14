"""Training driver: any LM/GNN/recsys arch at a *runnable* scale on one
device, with the full production runtime — AdamW, checkpointing,
crash-resume, optional int8 gradient compression, straggler journal.

It runs on the card; ``--device cpu`` runs it on the CPU, and without
CUDA and without ``--device cpu`` it raises.  Every GNN arch trains on
neighbour-sampled batches of a random 2,048-node graph, as the
reference's launcher does: ``schnet`` and ``graphcast`` need fields those
batches lack and fail with the reference's ``KeyError`` (``'edge_feat'``,
``'mesh_feat'``).

Usage:
  python -m repro_torch.launch.train --arch qwen2-7b --steps 200 \
      --scale smoke [--compress-grads] [--ckpt-dir DIR] \
      [--device cpu]
  python -m repro_torch.launch.train --arch gin-tu --scale full --steps 3
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..configs import get_config
from ..configs.base import batch_to
from ..torchgm import frontier
from ..train import (AdamWConfig, ElasticConfig, ElasticTrainer,
                     make_int8_compressor)
from ..train import optimizer as opt
from ..train.compression import init_error_state


def build_lm(arch, args, device: torch.device):
    """(cfg, init_params, loss_fn, batch_fn) of an LM arch on ``device``."""
    from ..data.tokens import TokenPipeline, TokenPipelineConfig
    from ..models import transformer as tf
    cfg = arch.smoke_config() if args.scale == "smoke" else arch.cfg
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len,
        seed=args.seed))
    loss = lambda p, b: tf.loss_fn(p, b, cfg)  # noqa: E731
    init = lambda: tf.TransformerLM(  # noqa: E731
        cfg, generator=torch.Generator(device).manual_seed(args.seed)).params
    batch_fn = lambda i: batch_to(pipe.batch_at(i), device)  # noqa: E731
    return cfg, init, loss, batch_fn


def build_gnn(arch, args, device: torch.device):
    """(cfg, init_params, loss_fn, batch_fn) of a GNN arch on ``device``:
    sampled batches (64 seeds, fan-out 8-4) of a random CSR graph."""
    from ..data.sampler import random_csr_graph, sampled_batch
    from ..models import gnn
    cfg = arch.smoke_config() if args.scale == "smoke" else arch.cfg
    g = random_csr_graph(2048, avg_deg=8, d_feat=cfg.d_feat,
                         n_classes=cfg.n_classes, seed=args.seed)
    loss = lambda p, b: gnn.loss_fn(p, b, cfg)  # noqa: E731
    init = lambda: gnn.GNN(  # noqa: E731
        cfg, generator=torch.Generator(device).manual_seed(args.seed)).params
    batch_fn = lambda i: batch_to(sampled_batch(  # noqa: E731
        g, 64, (8, 4), i, seed=args.seed), device)
    return cfg, init, loss, batch_fn


def build_din(arch, args, device: torch.device):
    """(cfg, init_params, loss_fn, batch_fn) of DIN on ``device``:
    synthetic click logs of ``--batch`` examples, seeded by step."""
    from ..data.recsys_data import din_batch
    from ..models import recsys
    cfg = arch.smoke_config() if args.scale == "smoke" else arch.cfg
    loss = lambda p, b: recsys.loss_fn(p, b, cfg)  # noqa: E731
    init = lambda: recsys.DIN(  # noqa: E731
        cfg, generator=torch.Generator(device).manual_seed(args.seed)).params
    batch_fn = lambda i: batch_to(din_batch(  # noqa: E731
        args.batch, cfg.seq_len, cfg.n_items, cfg.n_cates,
        cfg.n_user_feats, cfg.user_feat_vocab, step=i, seed=args.seed),
        device)
    return cfg, init, loss, batch_fn


BUILDERS = {"lm": build_lm, "gnn": build_gnn, "recsys": build_din}


def make_step(loss_fn, ocfg: AdamWConfig, compressor=None):
    """The trainer's step: (state, batch) -> (state, metrics) over a state
    ``{"params", "opt"[, "err"]}``, through ``make_train_step`` (one
    forward and backward gives the gradients and the loss)."""
    inner = opt.make_train_step(loss_fn, ocfg, compressor)

    def step(state, batch):
        if compressor:
            params, ostate, err, m = inner(state["params"], state["opt"],
                                           batch, state["err"])
            return {"params": params, "opt": ostate, "err": err}, m
        params, ostate, m = inner(state["params"], state["opt"], batch)
        return {"params": params, "opt": ostate}, m

    return step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated crash (test fault tolerance)")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the current CUDA "
                         "device; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.device:
        frontier.DEFAULT_DEVICE = args.device
    device = frontier.resolve()    # no CUDA and no --device cpu: raise now

    arch = get_config(args.arch)
    cfg, init_params, loss_fn, batch_fn = BUILDERS[arch.family](
        arch, args, device)

    ocfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                       total_steps=args.steps, weight_decay=0.01)
    compressor = make_int8_compressor() if args.compress_grads else None

    def init_state():
        params = init_params()
        state = {"params": params, "opt": opt.init_state(params)}
        if compressor:
            state["err"] = init_error_state(params)
        return state

    trainer = ElasticTrainer(
        step_fn=make_step(loss_fn, ocfg, compressor), make_batch=batch_fn,
        init_state=init_state,
        cfg=ElasticConfig(checkpoint_dir=args.ckpt_dir,
                          checkpoint_every=args.ckpt_every),
        get_step=lambda s: int(s["opt"]["step"]))
    info = trainer.start_or_resume()
    print(f"[train] {args.arch} family={arch.family} device={device} "
          f"resumed={info['resumed']} from step {info['step']}")
    t0 = time.time()
    out = trainer.run(args.steps, fail_at=args.fail_at)
    losses = [m["loss"] for m in out["metrics"]]
    trend = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses
             else "no step left to run")
    print(f"[train] done: step={out['final_step']} {trend} "
          f"({time.time() - t0:.1f}s, stragglers={out['straggler_flags']})")


if __name__ == "__main__":
    main()
