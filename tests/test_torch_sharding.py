"""The port's dry-run units against the reference's, leaf by leaf.

For every (arch, shape, mesh) cell of the production meshes, ``(16, 16)``
``("data", "model")`` and ``(2, 16, 16)`` ``("pod", "data", "model")``:
each argument's global shape, its dtype (through a fixed map: the packed
``uint32`` words are the port's ``int32`` lanes) and its placements on the
port's mesh (a fake process group of 256 or 512 ranks) equal the
reference's ``ShapeDtypeStruct`` and ``in_shardings`` spec read through
``dist.sharding.placements``, from the reference's ``build_dryrun`` on an
``AbstractMesh``.  ``abstract_params`` equals ``jax.eval_shape`` of the
reference's ``init_params`` for every arch on both meshes' configs.
Exact.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32, "uint32": torch.int32, "bool": torch.bool}
CELLS = [(a, s, m) for a in all_arch_ids() for s in get_config(a).shapes
         for m in MESHES]


@pytest.fixture
def port_mesh(request):
    """The production mesh of ``request.param`` over a fake group,
    destroyed after the test."""
    kind = request.param
    with fake_group(256 if kind == "pod" else 512):
        yield make_production_mesh(multi_pod=kind == "multipod")


def _ref_mesh(kind):
    return AbstractMesh(*MESHES[kind])


def _ref_leaves(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        parts = []
        for k in path:
            for attr in ("idx", "key", "name"):
                if hasattr(k, attr):
                    parts.append(str(getattr(k, attr)))
                    break
        out["/".join(parts)] = leaf
    return out


def _port_leaves(tree, prefix=""):
    from torch.distributed.tensor.placement_types import Placement
    if isinstance(tree, torch.Tensor) or (
            isinstance(tree, tuple) and tree
            and all(isinstance(p, Placement) for p in tree)):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif is_dataclass(tree):             # the reference's NamedTuple
        items = enumerate(getattr(tree, f.name) for f in fields(tree))
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _is_sharding(x):
    return hasattr(x, "spec")


@pytest.mark.parametrize("port_mesh,arch,shape",
                         [(m, a, s) for a, s, m in CELLS],
                         indirect=["port_mesh"],
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_unit_matches_reference(port_mesh, arch, shape):
    kind = "multipod" if len(port_mesh.shape) == 3 else "pod"
    ref = ref_get_config(arch).build_dryrun(shape, _ref_mesh(kind))
    unit = get_config(arch).build_dryrun(shape, port_mesh)
    assert unit.name == ref.name
    assert unit.donate == tuple(ref.donate)
    ref_args = _ref_leaves(ref.args)
    ref_specs = _ref_leaves(tuple(ref.in_shardings), is_leaf=_is_sharding)
    args = _port_leaves(unit.args)
    pls = _port_leaves(unit.placements)
    assert sorted(args) == sorted(ref_args) == sorted(pls) \
        == sorted(ref_specs)
    for path, want in ref_args.items():
        got = args[path]
        assert tuple(got.shape) == tuple(want.shape), path
        assert got.dtype == DTYPES[str(want.dtype)], path
        assert pls[path] == shd.placements(tuple(ref_specs[path].spec),
                                           port_mesh), path


@pytest.mark.parametrize("port_mesh", list(MESHES), indirect=True)
@pytest.mark.parametrize("arch", [a for a in all_arch_ids()
                                  if a != "rig_gm"])
def test_abstract_params_match_reference(port_mesh, arch):
    kind = "multipod" if len(port_mesh.shape) == 3 else "pod"
    ref, port = ref_get_config(arch), get_config(arch)
    if port.family == "lm":
        import repro.models.transformer as ref_mod
        from repro_torch.models import transformer as mod
        ref_cfg = ref._mesh_cfg(_ref_mesh(kind))
        cfg = port._mesh_cfg(port_mesh)
        assert (cfg.hq, cfg.hkv) == (ref_cfg.hq, ref_cfg.hkv)
    else:
        if port.family == "gnn":
            import repro.models.gnn as ref_mod
            from repro_torch.models import gnn as mod
        else:
            import repro.models.recsys as ref_mod
            from repro_torch.models import recsys as mod
        ref_cfg, cfg = ref.cfg, port.cfg
    want = _ref_leaves(jax.eval_shape(
        lambda: ref_mod.init_params(ref_cfg, jax.random.key(0))))
    got = _port_leaves(mod.abstract_params(cfg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert got[path].dtype == DTYPES[str(w.dtype)], path
        assert got[path].device.type == "meta"


def test_placements_follow_the_mesh_order():
    """A tuple of axes splits in the mesh's order; another order or one
    axis on two dimensions raises."""
    with fake_group(512):
        mesh = make_production_mesh(multi_pod=True)
        from torch.distributed.tensor import Replicate, Shard
        assert shd.placements((("pod", "data"), None), mesh) \
            == (Shard(0), Shard(0), Replicate())
        assert shd.placements((None, None, ("pod", "data", "model")),
                              mesh) == (Shard(2),) * 3
        assert shd.placements((), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="mesh's order"):
            shd.placements((("data", "pod"),), mesh)
        with pytest.raises(ValueError, match="splits two"):
            shd.placements(("model", "model"), mesh)
