"""Multi-pod dry-run: trace every (architecture × shape × mesh) unit on fake
tensors over a fake process group.

For each cell:

* start a ``fake`` process group of the mesh's 256 or 512 ranks (rank 0;
  no network, no card) and build the production mesh over it;
* build the arch's :class:`~repro_torch.configs.base.DryRunUnit` and make
  each argument a ``meta`` tensor (shapes and dtypes, no storage) of rank
  0: a ``DTensor`` of the unit's placements, or, for a unit that issues
  its collectives itself, rank 0's own block;
* run the step once, as rank 0, under one recorder of the operators rank
  0 itself runs (a ``DTensor`` operator is counted in the local operators
  ``DTensor`` runs for it): their FLOPs, by ``FlopCounterMode``'s formula
  table (``torch.utils.flop_counter.flop_registry``, which holds the
  kernels' own formulas too); the bytes they read and write; the peak of
  live bytes, arguments and temporaries apart; and a census of the
  collectives issued (``DTensor``'s redistributions and the steps' own
  ``torch.distributed`` calls alike: count, output bytes, payload bytes,
  group size, and ring-model wire bytes).

The FLOPs are rank 0's own work, the per-device count itself, and not a
``DTensor``-level count over the devices: the attention of the LM units
runs on each rank's block of batch rows and heads
(``models.transformer._per_block``), out of ``DTensor``'s sight, and a
rank also counts what it computes redundantly where an operator runs
replicated.  ``flops_global`` is that count times the devices.

The tensors are ``meta`` tensors, not ``FakeTensorMode``'s fakes:
``DTensor`` reads index tensors that it makes itself on the host to place
strided shards (attention's batch-by-heads products make them), which
under ``FakeTensorMode`` are fakes with no values, and a torch built
without CUDA aborts when autograd records an operation on a fake ``cuda``
tensor.  A ``meta`` tensor has the same shape, dtype and operators, runs
under autograd anywhere, and leaves ``DTensor``'s own host tensors real.
The mesh is a ``cuda`` mesh; the kernels are traced through their
operators' fakes, never their plain versions; nothing is allocated and no
card is touched.  Results append to a JSON manifest (``--skip-existing``
resumes a sweep).

The records keep the reference's keys, except where torch has no
counterpart: ``lower_s`` and ``compile_s`` become ``trace_s`` (nothing is
compiled); ``memory`` holds ``argument_size_in_bytes``,
``temp_size_in_bytes`` (the peak of live bytes the step allocated, its
outputs included), ``output_size_in_bytes`` and ``peak_size_in_bytes``
(their sum at the peak), and leaves out ``generated_code_size_in_bytes``
and ``alias_size_in_bytes`` (no code is generated; the steps update their
donated arguments in place, so nothing aliases); ``cost`` holds ``flops``
and ``bytes accessed`` (every non-view operator's input and output bytes,
per device) and leaves out ``transcendentals`` and ``optimal_seconds``.

Usage:
  python -m repro_torch.launch.dryrun [--arch yi-34b] [--shape train_4k]
      [--mesh pod|multipod|both] [--out results/dryrun_torch.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
import traceback
import weakref
from dataclasses import fields, is_dataclass
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import _sharding_prop
from torch.distributed.tensor.experimental import implicit_replication
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from ..configs import all_arch_ids, get_config
from ..dist.sharding import contiguous_stride
from .mesh import make_production_mesh

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
MESHES = {"pod": 256, "multipod": 512}


# ------------------------------------------------------------ fake group
@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process rank 0, destroyed on exit.  Raises if a group is running: a
    process has one default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is running; destroy it before "
                           "starting the dry-run's fake group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- trees
def _map(fn, tree, pl):
    """``fn(leaf, placements)`` over a unit's argument tree and the
    placement tree beside it (dicts, lists, tuples, dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, pl)
    if isinstance(tree, dict):
        return {k: _map(fn, v, pl[k]) for k, v in tree.items()}
    if is_dataclass(tree):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name),
                                          getattr(pl, f.name))
                             for f in fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, p) for v, p in zip(tree, pl))
    raise TypeError(f"not an argument tree: {type(tree)}")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif is_dataclass(tree):
        for f in fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _rank_block(t, mesh, placements):
    """(local shape, slices) of this rank's block of a global ``t``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        tuple(t.shape), mesh, placements)
    return tuple(shape), tuple(slice(o, o + n)
                               for o, n in zip(offset, shape))


def _as_arg(local, unit, placements, shape):
    if unit.local:
        return local
    return DTensor.from_local(local, unit.mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def materialize(unit, device: str = "meta"):
    """The unit's arguments as rank 0 holds them, on ``device``
    (``meta``: shapes and dtypes, no storage): ``DTensor`` leaves of the
    unit's placements, or, for a ``local`` unit, rank 0's own blocks."""
    def one(meta: torch.Tensor, placements) -> torch.Tensor:
        local_shape, _ = _rank_block(meta, unit.mesh, placements)
        return _as_arg(torch.empty(local_shape, dtype=meta.dtype,
                                   device=device),
                       unit, placements, tuple(meta.shape))

    return tuple(_map(one, a, p) for a, p in zip(unit.args, unit.placements))


def place(unit, tensors):
    """This rank's arguments of ``unit`` from ``tensors``, its arguments
    whole (trees shaped as ``unit.args``, the same on every rank): each
    leaf's block of this rank, as a ``DTensor`` of the unit's placements
    or, for a ``local`` unit, as it is.  Nothing is sent."""
    def one(t: torch.Tensor, placements) -> torch.Tensor:
        _, block = _rank_block(t, unit.mesh, placements)
        return _as_arg(t[block].contiguous(), unit, placements,
                       tuple(t.shape))

    return tuple(_map(one, a, p) for a, p in zip(tensors, unit.placements))


def spread(unit):
    """The context a unit's step runs in: for a ``DTensor`` unit, plain
    tensors that the step makes (positions, masks, index ranges) taken as
    replicated, as a program's constants are; nothing for a ``local``
    unit."""
    return contextlib.nullcontext() if unit.local \
        else implicit_replication()


def call(unit, args):
    """``unit.step_fn(*args)`` in its context (:func:`spread`)."""
    with spread(unit):
        return unit.step_fn(*args)


# ------------------------------------------------------------- recorders
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _collective(func, args, out):
    """(kind, group size, output bytes, payload bytes) of a collective
    operator, else None.  Payload: the bytes each rank hands in (the
    tensor reduced, or sent), as ``torch.distributed``'s caller passes
    them."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns in ("_c10d_functional", "c10d_functional"):
        if name == "all_gather_into_tensor":
            return ("all-gather", args[1], _nbytes(out), _nbytes(args[0]))
        if name == "reduce_scatter_tensor":
            return ("reduce-scatter", args[2], _nbytes(out),
                    _nbytes(args[0]))
        if name == "all_reduce":
            return ("all-reduce", _group_size(args[2]), _nbytes(out),
                    _nbytes(args[0]))
        if name == "all_to_all_single":
            return ("all-to-all", _group_size(args[3]), _nbytes(out),
                    _nbytes(args[0]))
        if name == "broadcast":
            return ("collective-permute", _group_size(args[2]),
                    _nbytes(out), _nbytes(args[0]))
        if name in ("wait_tensor", "_wrap_tensor_autograd"):
            return None
        raise NotImplementedError(f"the census has no rule for {func}")
    if ns != "c10d":
        return None
    pg = next(a for a in args if isinstance(a, torch.ScriptObject))
    g = dist.ProcessGroup.unbox(pg).size()
    if name == "allgather_":
        outs = [t for row in args[0] for t in row]
        return ("all-gather", g, sum(map(_nbytes, outs)),
                sum(map(_nbytes, args[1])))
    if name == "_allgather_base_":
        return ("all-gather", g, _nbytes(args[0]), _nbytes(args[1]))
    if name == "allreduce_":
        b = sum(map(_nbytes, args[0]))
        return ("all-reduce", g, b, b)
    if name == "reduce_scatter_":
        ins = [t for row in args[1] for t in row]
        return ("reduce-scatter", g, sum(map(_nbytes, args[0])),
                sum(map(_nbytes, ins)))
    if name == "_reduce_scatter_base_":
        return ("reduce-scatter", g, _nbytes(args[0]), _nbytes(args[1]))
    if name in ("alltoall_", "alltoall_base_"):
        outs = args[0] if isinstance(args[0], list) else [args[0]]
        ins = args[1] if isinstance(args[1], list) else [args[1]]
        return ("all-to-all", g, sum(map(_nbytes, outs)),
                sum(map(_nbytes, ins)))
    if name == "broadcast_":
        b = sum(map(_nbytes, args[0]))
        return ("collective-permute", g, b, b)
    if name == "barrier":
        return None
    raise NotImplementedError(f"the census has no rule for {func}")


def _wire_bytes(kind: str, out_bytes: int, g: int) -> float:
    """Per-device wire traffic estimate from the op's *output* bytes.
    Ring-algorithm costs with group size g:
      all-gather       recv (g-1)/g · out
      all-reduce       2 · (g-1)/g · out           (reduce-scatter + AG)
      reduce-scatter   send (g-1) · out            (out = in/g)
      all-to-all       (g-1)/g · out
      collective-permute  out
    """
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(out_bytes) * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)


_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided", "_local_scalar_dense", "detach",
               "lift_fresh"}


def _in_sharding_propagation() -> bool:
    """Whether ``DTensor``'s sharding propagation called this operator:
    it runs operators on fakes, and through its decompositions on
    ``meta`` tensors, to work out an operator's placements and shapes.
    That is not the step's work, and ``DTensor`` caches it for the
    process, so counting it would make a record depend on what was traced
    before it."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code.co_filename == _sharding_prop.__file__:
            return True
        frame = frame.f_back
    return False


class _Recorder(TorchDispatchMode):
    """Rank 0's own operators (a ``DTensor`` operator is let through to
    ``DTensor``, which comes back with the local operators it runs): the
    collectives, the bytes each operator reads and writes, and the live
    bytes of every storage allocated, freed when its last tensor goes."""

    def __init__(self):
        super().__init__()
        self.calls = []              # (kind, group size, out B, payload B)
        self.bytes_accessed = 0
        self.flops = 0
        self.live = self.peak = 0
        self._known: Dict[int, int] = {}

    def arguments(self, args) -> None:
        """Mark the argument storages as known (not temporaries)."""
        for t in _tensors(args):
            self._known[_local(t).untyped_storage()._cdata] = 0

    def _free(self, key: int) -> None:
        self.live -= self._known.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        n = st.nbytes()
        self._known[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat_out = list(_tensors(out))
        if not any(t.is_meta for t in flat_out) and not any(
                t.is_meta for t in _tensors((args, kwargs))):
            # host tensors of DTensor's own bookkeeping: not the step's
            return out
        if any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack()) \
                or _in_sharding_propagation():
            # DTensor working out an operator's placements and output
            # shape on fakes or meta copies of its global arguments: not
            # the step's work
            return out
        coll = _collective(func, args, out)
        if coll is not None:
            self.calls.append(coll)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        name = func._schema.name.split("::")[-1]
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in flat_out)
        for t in flat_out:
            self._track(t)
        return out

    def census(self) -> dict:
        out = {k: {"count": 0, "output_bytes": 0, "payload_bytes": 0,
                   "wire_bytes": 0.0, "group_sizes": []}
               for k in COLLECTIVES}
        for kind, g, out_b, pay_b in self.calls:
            row = out[kind]
            row["count"] += 1
            row["output_bytes"] += out_b
            row["payload_bytes"] += pay_b
            row["wire_bytes"] += _wire_bytes(kind, out_b, g)
            if g not in row["group_sizes"]:
                row["group_sizes"].append(g)
        return out


def argument_bytes(args) -> int:
    """Bytes of the distinct storages of a tree of (D)Tensors, as this
    rank holds them."""
    seen = {}
    for t in _tensors(args):
        st = _local(t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def trace(unit) -> dict:
    """Run ``unit``'s step once on ``meta`` tensors as rank 0 of its mesh:
    ``flops`` (rank 0's own, per device), ``flops_global`` (that times
    the devices), ``bytes accessed`` (per device), the memory record, the
    collective census and the seconds the trace took."""
    args = materialize(unit)
    rec = _Recorder()
    rec.arguments(args)
    arg_bytes = argument_bytes(args)
    t0 = time.perf_counter()
    with spread(unit), rec:
        out = unit.step_fn(*args)
        out_bytes = sum(_local(t).untyped_storage().nbytes()
                        for t in _tensors(out)
                        if rec._known.get(_local(t).untyped_storage()
                                          ._cdata, 0))
    seconds = time.perf_counter() - t0
    n_dev = unit.mesh.size()
    return {
        "flops": float(rec.flops),
        "flops_global": rec.flops * n_dev,
        "bytes accessed": float(rec.bytes_accessed),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "temp_size_in_bytes": rec.peak,
                   "output_size_in_bytes": out_bytes,
                   "peak_size_in_bytes": arg_bytes + rec.peak},
        "collectives": rec.census(),
        "trace_s": seconds,
    }


# ------------------------------------------------------------ calibration
def _global_cost(unit) -> dict:
    """The whole program's cost from one trace: global FLOPs (a local
    unit's own times the devices) and per-device bytes times the devices
    (integers)."""
    t = trace(unit)
    n_dev = unit.mesh.size()
    return {"flops": int(t["flops_global"]),
            "bytes accessed": int(t["bytes accessed"]) * n_dev}


def lm_calibrated_cost(cfg, shape, mesh, n_dev: int) -> dict:
    """The reference's depth extrapolation: units of L = 2 and L = 4
    layers, everything linear in depth extrapolated to the config's
    depth: ``total(L) = fixed + per_layer · L``, ``per_layer = (C4 - C2)
    / 2``.  XLA needs it because its cost analysis counts a scan body
    once; the port's layers are a Python loop, traced whole, so this
    equals the direct count (the tests hold it to that), in integers."""
    c2 = _global_cost(cfg.build_dryrun(shape, mesh, layers_override=2,
                                       unroll=True))
    c4 = _global_cost(cfg.build_dryrun(shape, mesh, layers_override=4,
                                       unroll=True))
    n_layers = cfg.cfg.n_layers
    out = {}
    for key in ("flops", "bytes accessed"):
        per_layer, odd = divmod(c4[key] - c2[key], 2)
        if odd:
            raise ArithmeticError(f"{key}: C4 - C2 = {c4[key] - c2[key]} is "
                                  f"not two equal layers")
        glob = max(c2[key] + (n_layers - 2) * per_layer, 0)
        out[key] = glob / n_dev            # per-device share
        out[key + "_global"] = glob
    return out


# ------------------------------------------------------------------ cells
def record_of(arch_id: str, shape, mesh_kind: str, unit, cfg) -> dict:
    """The manifest record of one traced unit."""
    n_dev = unit.mesh.size()
    t = trace(unit)
    census = t["collectives"]
    return {
        "arch": arch_id, "shape": shape if isinstance(shape, str)
        else "custom", "mesh": mesh_kind, "n_devices": n_dev,
        "status": "ok",
        "trace_s": round(t["trace_s"], 2),
        "memory": t["memory"],
        "cost": {"flops": t["flops"], "bytes accessed": t["bytes accessed"],
                 "flops_global": t["flops_global"]},
        "collectives": census,
        "collective_wire_bytes_per_device": sum(
            v["wire_bytes"] for v in census.values()),
        "model_flops": float(cfg.model_flops(shape)),
    }


def run_cell(arch_id: str, shape: str, mesh_kind: str) -> dict:
    """Trace one cell on a fake group of the mesh's size (started here and
    destroyed on return)."""
    cfg = get_config(arch_id)
    with fake_group(MESHES[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
        unit = cfg.build_dryrun(shape, mesh)
        rec = record_of(arch_id, shape, mesh_kind, unit, cfg)
        if cfg.family == "lm":
            rec["cost_calibrated"] = lm_calibrated_cost(
                cfg, shape, mesh, rec["n_devices"])
    return rec


def error_record(arch_id: str, shape: str, mesh_kind: str,
                 exc: BaseException) -> dict:
    return {"arch": arch_id, "shape": shape, "mesh": mesh_kind,
            "status": "error", "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc()[-4000:]}


def record_cell(arch_id: str, shape: str, mesh_kind: str) -> dict:
    """:func:`run_cell`, or an ``error`` record with its traceback (an
    operator with no ``DTensor`` rule among them: a failure is a finding,
    never worked around)."""
    try:
        return run_cell(arch_id, shape, mesh_kind)
    except Exception as e:   # recorded: each is a finding
        if dist.is_initialized():
            dist.destroy_process_group()
        return error_record(arch_id, shape, mesh_kind, e)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    # DTensor warns of every two-step all-reduce on a multi-axis mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok"}

    archs = [args.arch] if args.arch else all_arch_ids()
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    t_all = time.perf_counter()
    for arch_id in archs:
        cfg = get_config(arch_id)
        shapes = [args.shape] if args.shape else list(cfg.shapes)
        for shape in shapes:
            for mesh_kind in meshes:
                key = (arch_id, shape, mesh_kind)
                if args.skip_existing and key in done:
                    print(f"[skip] {key}")
                    continue
                print(f"[dryrun] {arch_id} × {shape} × {mesh_kind} ...",
                      flush=True)
                rec = record_cell(arch_id, shape, mesh_kind)
                if rec["status"] == "ok":
                    print(f"  ok: trace={rec['trace_s']}s "
                          f"flops/dev={rec['cost']['flops']:.3e} "
                          f"peak/dev={rec['memory']['peak_size_in_bytes']:.3e}"
                          f" coll_B/dev="
                          f"{rec['collective_wire_bytes_per_device']:.3e}",
                          flush=True)
                else:
                    print(f"  ERROR: {rec['error']}", flush=True)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] manifest: {args.out} — {n_ok}/{len(results)} ok "
          f"({time.perf_counter() - t_all:.1f} s)")


if __name__ == "__main__":
    main()
