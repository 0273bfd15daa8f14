"""Hillclimbing: trace the baseline and its variants for the three
chosen cells, record all three roofline terms of each on an H100 cost
model, append to ``results/perf_iterations_torch.json``.

  python -m repro_torch.launch.hillclimb [--out ...] [--only ARCH]

The terms are a model, not a measurement: per device, the traced FLOPs
over the dense bf16 peak, the bytes its operators read and write over the
HBM rate, and the collectives' ring-model wire bytes over the link rate
(``launch.dryrun``).  The constants are NVIDIA's H100 SXM figures:

* ``PEAK`` — 989e12 FLOP/s, dense bf16 on the tensor cores (data sheet);
* ``HBM`` — 3.35e12 B/s of HBM3 (data sheet);
* ``LINK`` — 50e9 B/s a card: one 400 Gb/s NDR InfiniBand port per GPU,
  as a DGX H100 has.  The production meshes span 32 or 64 nodes of 8
  cards, and every axis of 16 crosses a node boundary, so a ring over an
  axis runs at the network's rate, not at NVLink's 450e9 B/s a direction
  within a node of 8.

The one peak takes every traced count, the kernels' too: ``bitmm``'s
int8 products (whose own peak is twice it) and ``closure_step``'s int32
word operations, which its formula counts for a dense R (every bit set,
the most it can do: a formula of shapes cannot read R's bits), so a
closure cell's compute term is a worst case.

``fits_80GB``: the traced peak of live bytes per device below the card's
80 GB.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from ..configs import get_config
from .dryrun import MESHES, fake_group, trace
from .mesh import make_production_mesh

PEAK, HBM, LINK = 989e12, 3.35e12, 50e9
CARD_BYTES = 80e9

# (arch, shape, mesh, variant, hypothesis)
CELLS = [
    # --- cell 1: yi-34b train_4k — worst LM roofline fraction, memory-bound
    ("yi-34b", "train_4k", "pod", "baseline",
     "baseline: dense T×T attention + full (B,T,V) f32 logits"),
    ("yi-34b", "train_4k", "pod", "flash",
     "H1: streaming KV chunks (online softmax) removes the (B,H,T,T) score "
     "buffer -> memory term drops ~T/chunk on the attention share"),
    ("yi-34b", "train_4k", "pod", "flash+chunkloss",
     "H2: streaming lm_head CE removes the (B,T,V) f32 logits buffer "
     "-> remaining memory term drops toward the parameter/activation floor"),
    ("yi-34b", "train_4k", "pod", "flash+chunkloss+wsc",
     "H10: pin activations' batch dim to the data axes at every layer "
     "boundary, so that the layers keep the batch split"),
    ("yi-34b", "train_4k", "pod", "flash+chunkloss+wsc+ckptchunk",
     "H11: checkpoint the flash chunk body (the port always does): the "
     "same unit as H10"),
    # --- extension: the validated LM chain on two more train cells
    ("qwen2-7b", "train_4k", "pod", "baseline",
     "baseline for comparison"),
    ("qwen2-7b", "train_4k", "pod", "flash+chunkloss+wsc+ckptchunk",
     "H1+H2+H10+H11 transferred: same memory-bound profile as yi"),
    ("grok-1-314b", "train_4k", "pod", "baseline",
     "baseline for comparison — the one compute-bound LM train cell"),
    ("grok-1-314b", "train_4k", "pod", "flash+chunkloss+wsc+ckptchunk",
     "H12: on a compute-bound cell the chain should move memory/collective "
     "terms but not the roofline fraction (bound stays compute)"),
    # --- cell 2: gin-tu ogb_products — most collective-bound cell
    ("gin-tu", "ogb_products", "pod", "baseline",
     "baseline: DTensor placements scatter the (E,d) messages across "
     "shards"),
    ("gin-tu", "ogb_products", "pod", "shardmap",
     "H3: dst-partitioned edges + one all-gather of the (N,d) feature "
     "matrix per layer -> collective volume independent of E (N·d vs E·d)"),
    # --- cell 3: rig_gm serve_1m — the paper-technique cell
    ("rig_gm", "serve_1m", "pod", "baseline",
     "baseline: the bitmm kernel on each tile, bool Y gather"),
    ("rig_gm", "serve_1m", "pod", "packy",
     "H4: Y is bits; pack to int32 lanes before the all-gather -> 8x less "
     "wire"),
    ("rig_gm", "serve_1m", "pod", "b128",
     "H5: 4x query batch amortizes the packed-matrix reads -> per-query "
     "memory term ~4x lower (matrix traffic dominates and is "
     "batch-invariant)"),
    ("rig_gm", "serve_1m", "pod", "bk1024",
     "H8: the reference's smaller unpack chunks; the bitmm kernel unpacks "
     "in registers and has no chunk: the same unit as the baseline"),
    ("rig_gm", "serve_1m", "pod", "scan-artifact",
     "H9: the reference's scanned blocked matmul; the port has no such "
     "form: the same unit as the baseline"),
    ("rig_gm", "serve_1m", "pod", "best",
     "H4+H5 combined: packed Y + 128-query batch"),
]


def terms_of(flops_dev: float, bytes_dev: float, wire: float,
             batch_scale: float = 1.0) -> dict:
    """The three roofline terms, in seconds per device (per query batch
    of the baseline's size where ``batch_scale`` > 1)."""
    return {"t_compute_s": flops_dev / PEAK / batch_scale,
            "t_memory_s": bytes_dev / HBM / batch_scale,
            "t_collective_s": wire / LINK / batch_scale}


def roofline(rec: dict, model_flops: float, n_dev: int,
             batch_scale: float = 1.0) -> dict:
    """Terms, dominant term, bound and roofline fraction of a traced
    record (``launch.dryrun.trace``'s keys)."""
    wire = sum(v["wire_bytes"] for v in rec["collectives"].values())
    terms = terms_of(rec["flops"], rec["bytes accessed"], wire, batch_scale)
    bound = max(terms.values())
    mem = rec["memory"]
    return {
        "terms": terms, "dominant": max(terms, key=terms.get),
        "bound_s": bound,
        "roofline_fraction": (model_flops / (n_dev * PEAK * bound)
                              if bound else 0.0),
        "memory": {
            "args_GB": mem["argument_size_in_bytes"] / 1e9,
            "temp_GB": mem["temp_size_in_bytes"] / 1e9,
            "out_GB": mem["output_size_in_bytes"] / 1e9,
            "peak_GB": mem["peak_size_in_bytes"] / 1e9,
            "fits_80GB": mem["peak_size_in_bytes"] < CARD_BYTES,
        },
        "wire_bytes_per_dev": wire,
    }


def lower_cell(arch_id, shape, mesh_kind, variant):
    """Trace one (cell, variant) on a fake group of the mesh's size."""
    cfg = get_config(arch_id)
    with fake_group(MESHES[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
        n_dev = int(mesh.size())
        unit = cfg.build_dryrun(shape, mesh, variant=variant) \
            if variant != "baseline" else cfg.build_dryrun(shape, mesh)
        # the direct count: the reference's depth calibration stands in
        # for an XLA count that misses loop trips; a trace misses none
        rec = trace(unit)
    batch_scale = 4.0 if variant in ("b128", "best") else 1.0  # per-query
    out = {"arch": arch_id, "shape": shape, "mesh": mesh_kind,
           "variant": variant,
           **roofline(rec, cfg.model_flops(shape), n_dev, batch_scale)}
    out["constants"] = {"PEAK": PEAK, "HBM": HBM, "LINK": LINK}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/perf_iterations_torch.json")
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r["variant"])
            for r in results if "terms" in r}
    for (arch, shape, mesh_kind, variant, hyp) in CELLS:
        if args.only and arch != args.only:
            continue
        key = (arch, shape, mesh_kind, variant)
        if key in done:
            print(f"[skip] {key}")
            continue
        print(f"[perf] {arch} × {shape} × {variant} ...", flush=True)
        t0 = time.time()
        try:
            rec = lower_cell(arch, shape, mesh_kind, variant)
            rec["hypothesis"] = hyp
            rec["wall_s"] = round(time.time() - t0, 1)
            t = rec["terms"]
            print(f"  compute={t['t_compute_s']:.3e} "
                  f"memory={t['t_memory_s']:.3e} "
                  f"coll={t['t_collective_s']:.3e} "
                  f"dominant={rec['dominant']} "
                  f"fits={rec['memory']['fits_80GB']}", flush=True)
        except Exception as e:   # recorded: each is a finding
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "variant": variant, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-3000:]}
            print(f"  ERROR {e}", flush=True)
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"],
                       r["variant"]) != key]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
