"""The dry-run's recorders (``repro_torch.launch.dryrun``) and the H100
cost model (``repro_torch.launch.hillclimb``).

* The census is what a real run issues: on a ``(2, 4)`` mesh the
  fake-group trace of ``gm_serve_step``'s unit and of one
  ``models.gnn_dist`` step counts, per kind, the calls and payload bytes
  that 8 spawned gloo ranks count with ``chip_smoke.py``'s
  ``Collectives`` recorder in a real run of the same local shapes.
* FLOPs: an LM smoke config's train unit on a ``(2, 2)`` fake mesh counts
  exactly the matmul FLOPs worked out here from its shapes (forward,
  remat recompute, backward; attention included), a quarter on each
  rank; ``lm_calibrated_cost`` from 2 and 4 layers equals the direct
  count at 5 (FLOPs and bytes, on every mesh); a unit traced twice in
  one process gives one record; ``bitmm``'s
  formula equals PERF.md's operation count at the serve path's shape.
* An operator with no ``DTensor`` rule makes an ``error`` record naming
  it; ``_wire_bytes`` equals the reference's; hillclimb's terms for a
  record worked by hand with the H100 constants.

The ranks import neither JAX nor the reference package (this module
imports them only inside tests).
"""

from __future__ import annotations

import json
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch.dryrun import fake_group, trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, SHAPE = 8, (2, 4)
N_PAD, BATCH, PASSES = 4096, 2, 4          # serve unit: top_k 4,096
GNN_N = GNN_E = 4096                       # gnn_dist unit: 512 a rank
RANK_TIMEOUT_S = 300


def _serve_shape():
    return dict(kind="serve", n_pad=N_PAD, batch=BATCH, passes=PASSES)


def _gnn_arch():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import GNNArch
    return GNNArch(get_config("gin-tu").smoke_config())


def _gnn_shape():
    return dict(kind="train", n_nodes=GNN_N, n_edges=GNN_E, d_feat=8)


# ------------------------------------------------------------ one rank
def _rank(rank, out_dir, store_file):
    """A real step of each unit's function on random tensors of the
    unit's local shapes, counted by ``chip_smoke.Collectives``."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Collectives

    from repro_torch.configs.base import OPT
    from repro_torch.configs.pattern import MAX_E, MAX_Q
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.torchgm import distributed, frontier
    from repro_torch.torchgm.encoding import QueryTensor
    from repro_torch.train import init_state

    torch.set_num_threads(1)
    frontier.DEFAULT_DEVICE = "cpu"
    dist.init_process_group("gloo", store=dist.FileStore(store_file, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    out = {}
    try:
        mesh = make_local_mesh(*SHAPE)
        g = torch.Generator().manual_seed(rank)
        rows_l, w_l = N_PAD // SHAPE[0], N_PAD // 32 // SHAPE[1]
        mats = torch.randint(-2**31, 2**31 - 1, (4, rows_l, w_l),
                             generator=g, dtype=torch.int32)
        labels = torch.randint(0, 3, (N_PAD // SHAPE[1],), generator=g,
                               dtype=torch.int32)
        qts = QueryTensor(
            labels=torch.randint(0, 3, (BATCH, MAX_Q), dtype=torch.int32),
            edge_src=torch.zeros((BATCH, MAX_E), dtype=torch.int32),
            edge_dst=torch.ones((BATCH, MAX_E), dtype=torch.int32),
            edge_kind=torch.zeros((BATCH, MAX_E), dtype=torch.int32),
            n_nodes=torch.full((BATCH,), 2, dtype=torch.int32),
            n_edges=torch.ones((BATCH,), dtype=torch.int32))
        coll = Collectives()
        try:
            distributed.gm_serve_step(mats, labels, qts, mesh,
                                      n_passes=PASSES, top_k=4096)
        finally:
            coll.restore()
        out["serve"] = coll.summary()

        cfg = _gnn_arch()._shape_cfg(_gnn_shape())
        n_l, e_l = GNN_N // WORLD, GNN_E // WORLD
        batch = {"node_feat": torch.randn(n_l, cfg.d_feat, generator=g),
                 "edge_src": torch.randint(0, GNN_N, (e_l,), generator=g,
                                           dtype=torch.int32),
                 "edge_dst": torch.randint(0, n_l, (e_l,), generator=g,
                                           dtype=torch.int32),
                 "labels": torch.randint(0, cfg.n_classes, (n_l,),
                                         generator=g, dtype=torch.int32),
                 "node_mask": torch.ones(n_l, dtype=torch.bool),
                 "train_mask": torch.ones(n_l, dtype=torch.bool)}
        params = gnn.GNN(cfg, generator=torch.Generator().manual_seed(0)
                         ).params
        step, _ = gnn_dist.sharded_train_step(cfg, mesh, OPT)
        state = init_state(params)
        coll = Collectives()
        try:
            step(params, state, batch)
        finally:
            coll.restore()
        out["gnn_dist"] = coll.summary()
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


@pytest.fixture(scope="module")
def real_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("census")
    ctx = mp.start_processes(_rank, args=(str(tmp), str(tmp / "store")),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{WORLD} ranks did not finish in {RANK_TIMEOUT_S} s")
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _fake_unit(which, mesh):
    from repro_torch.configs import get_config
    if which == "serve":
        return get_config("rig_gm").build_dryrun(_serve_shape(), mesh)
    return _gnn_arch().build_dryrun(_gnn_shape(), mesh, variant="shardmap")


@pytest.mark.parametrize("which", ["serve", "gnn_dist"])
def test_census_equals_a_real_gloo_run(real_counts, which):
    from repro_torch.launch.mesh import make_local_mesh
    with fake_group(WORLD):
        t = trace(_fake_unit(which, make_local_mesh(*SHAPE)))
    got = {k.replace("-", "_"): [v["count"], v["payload_bytes"]]
           for k, v in t["collectives"].items() if v["count"]}
    for ranks in real_counts:          # every rank issues the same calls
        assert ranks[which] == real_counts[0][which]
    assert got == real_counts[0][which]
    assert got, "the unit issued no collective"


# ---------------------------------------------------------------- FLOPs
def _lm_arch(n_layers=2):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LMArch
    cfg = get_config("qwen2-7b").smoke_config()
    return LMArch(dataclasses.replace(cfg, n_layers=n_layers))


def _lm_matmul_flops(cfg, b, t, n_layers):
    """Forward, remat recompute and backward (two products a product)
    matmul FLOPs of the train step, from the shapes.  The recompute stops
    once it has what the backward reads (torch's non-reentrant
    checkpoint stops early): each layer's last product, w2, is not run
    again."""
    bt, d, hd = b * t, cfg.d_model, cfg.head_dim
    w2 = 2 * bt * cfg.d_ff * d
    layer = (2 * bt * d * cfg.hq * hd + 2 * 2 * bt * d * cfg.hkv * hd
             + 2 * 2 * b * cfg.hq * t * t * hd            # scores, A·V
             + 2 * bt * cfg.hq * hd * d                   # wo
             + 2 * 2 * bt * d * cfg.d_ff + w2)            # w1, w3, w2
    head = 2 * bt * d * cfg.vocab
    return n_layers * (4 * layer - w2) + 3 * head


def test_lm_train_flops_on_2x2_mesh_equal_the_shapes_count():
    from repro_torch.launch.mesh import make_local_mesh
    arch = _lm_arch()
    shape = dict(kind="train", seq_len=32, global_batch=4)
    with fake_group(4):
        mesh = make_local_mesh(2, 2)
        cfg = arch._mesh_cfg(mesh)
        t = trace(arch.build_dryrun(shape, mesh))
    want = _lm_matmul_flops(cfg, 4, 32, cfg.n_layers)
    assert t["flops_global"] == want
    assert t["flops"] == want / 4


@pytest.mark.parametrize("shape,world", [((1, 1), 1), ((2, 2), 4)])
def test_lm_calibrated_cost_equals_the_direct_count(shape, world):
    """FLOPs and bytes exactly, on every mesh."""
    from repro_torch.launch.mesh import make_local_mesh
    arch = _lm_arch(n_layers=5)
    unit_shape = dict(kind="train", seq_len=32, global_batch=4)
    with fake_group(world):
        mesh = make_local_mesh(*shape)
        direct = trace(arch.build_dryrun(unit_shape, mesh))
        cal = dryrun.lm_calibrated_cost(arch, unit_shape, mesh, world)
    assert cal["flops_global"] == direct["flops_global"]
    assert cal["flops"] == direct["flops"]
    assert cal["bytes accessed"] == direct["bytes accessed"]


def test_a_trace_does_not_depend_on_what_was_traced_before():
    """DTensor works out an operator's placements by running it on fakes
    and, through its decompositions, on ``meta`` tensors, and caches that
    for the process: the recorder counts none of it, so a unit traced
    twice in one process gives one record.  The shapes are this test's
    own, so that the first trace meets no cached propagation."""
    from repro_torch.launch.mesh import make_local_mesh
    shape = dict(kind="train", n_nodes=1032, n_edges=1544, d_feat=11)
    recs = []
    for _ in range(2):
        with fake_group(4):
            rec = trace(_gnn_arch().build_dryrun(shape, make_local_mesh(2, 2)))
        rec.pop("trace_s")
        recs.append(rec)
    assert recs[0] == recs[1]


def test_bitmm_formula_equals_the_kernel_count_at_the_serve_shape():
    """PERF.md's bitmm row: A 76,288 x 2,384 lanes by X 76,288 x 64, an
    operation bound of 0.376423 ms at the int8 tensor cores' 1,979 TOP/s."""
    from repro_torch.kernels.bitmm import bitmm_flops
    ops = bitmm_flops((76288, 2384), (76288, 64))
    assert ops == 2 * 76288 * 32 * 2384 * 64
    assert round(ops / 1979e12 * 1e3, 6) == 0.376423


# ----------------------------------------------------- records and model
@torch.library.custom_op("dryrun_test::halve", mutates_args=())
def _halve(x: torch.Tensor) -> torch.Tensor:
    return x / 2


@_halve.register_fake
def _(x):
    return torch.empty_like(x)


class _NoRuleArch:
    """An arch whose unit calls an operator DTensor has no rule for."""
    family = "test"
    shapes = {"s": {}}

    def build_dryrun(self, shape, mesh):
        from repro_torch.configs.base import DryRunUnit
        from repro_torch.dist.sharding import placements
        return DryRunUnit(
            name="norule:s", step_fn=lambda x: torch.ops.dryrun_test.halve(x),
            args=(torch.empty((32, 8), device="meta"),),
            placements=(placements((("data",), None), mesh),), mesh=mesh)

    def model_flops(self, shape):
        return 0.0


def test_an_operator_without_a_rule_is_an_error_record(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda _: _NoRuleArch())
    rec = dryrun.record_cell("norule", "s", "pod")
    assert rec["status"] == "error"
    assert "dryrun_test.halve" in rec["error"] + rec["traceback"]
    assert not dist.is_initialized()


def test_wire_bytes_equal_the_reference():
    saved = os.environ.get("XLA_FLAGS")
    try:                   # the reference's module sets XLA_FLAGS on import
        from repro.launch.dryrun import _wire_bytes as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for kind in dryrun.COLLECTIVES:
        for g in (1, 2, 16, 512):
            for b in (0, 4096, 123_456_789):
                assert dryrun._wire_bytes(kind, b, g) == ref(kind, b, g)


def test_hillclimb_terms_worked_by_hand():
    rec = {"flops": 2 * 989e12, "bytes accessed": 3.35e12 / 4,
           "collectives": {"all-gather": {"wire_bytes": 25e9},
                           "all-reduce": {"wire_bytes": 50e9}},
           "memory": {"argument_size_in_bytes": 10e9,
                      "temp_size_in_bytes": 75e9,
                      "output_size_in_bytes": 1e9,
                      "peak_size_in_bytes": 85e9}}
    out = hillclimb.roofline(rec, model_flops=256 * 989e12, n_dev=256)
    assert out["terms"] == {"t_compute_s": 2.0, "t_memory_s": 0.25,
                            "t_collective_s": 1.5}
    assert out["dominant"] == "t_compute_s" and out["bound_s"] == 2.0
    assert out["roofline_fraction"] == 0.5
    assert out["memory"]["fits_80GB"] is False
    assert out["wire_bytes_per_dev"] == 75e9
    assert (hillclimb.PEAK, hillclimb.HBM, hillclimb.LINK) \
        == (989e12, 3.35e12, 50e9)
    per_query = hillclimb.roofline(rec, 256 * 989e12, 256, batch_scale=4.0)
    assert per_query["terms"]["t_compute_s"] == 0.5


def test_hillclimb_cell_reads_its_trace():
    rec = hillclimb.lower_cell("rig_gm", "serve_1m", "pod", "packy")
    with fake_group(256):
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_production_mesh
        t = trace(get_config("rig_gm").build_dryrun(
            "serve_1m", make_production_mesh(), variant="packy"))
    wire = sum(v["wire_bytes"] for v in t["collectives"].values())
    assert rec["terms"] == hillclimb.terms_of(t["flops"],
                                              t["bytes accessed"], wire)
    assert rec["constants"] == {"PEAK": 989e12, "HBM": 3.35e12,
                                "LINK": 50e9}


def test_one_default_group_at_a_time():
    with fake_group(4):
        with pytest.raises(RuntimeError, match="process group is running"):
            with fake_group(4):
                pass
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(2, 2)
        assert mesh.device_type == "cuda"
        with pytest.raises(ValueError, match="needs 16 ranks"):
            make_local_mesh(4, 4)
    assert not dist.is_initialized()
