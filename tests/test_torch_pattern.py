"""The port's ``rig_gm`` arch (``repro_torch.configs.pattern``) and the
registry against the JAX package's, on the CPU: shapes, ``model_flops``
for every shape, the smoke's dict for four seeds (``TorchGM`` on the
kernels' plain versions against the reference's ``JaxGM``), and each
shape's dry-run unit against the reference's."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import ASSIGNED as REF_ASSIGNED  # noqa: E402
from repro.configs import all_arch_ids as ref_arch_ids  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro_torch.configs import ASSIGNED, all_arch_ids, get_config  # noqa: E402
from repro_torch.configs.pattern import MAX_E, MAX_Q, PatternArch  # noqa: E402


def test_registry_matches_reference():
    for include in (True, False):
        assert all_arch_ids(include_pattern=include) \
            == ref_arch_ids(include_pattern=include)
    assert ASSIGNED == REF_ASSIGNED == all_arch_ids(include_pattern=False)
    for arch_id in all_arch_ids():
        assert get_config(arch_id).family == ref_get_config(arch_id).family
        assert get_config(arch_id).arch_id == arch_id


def test_pattern_arch_matches_reference():
    from repro.configs import pattern as ref_pattern

    port, ref = get_config("rig_gm"), ref_get_config("rig_gm")
    assert isinstance(port, PatternArch)
    assert (port.family, port.arch_id) == ("pattern", "rig_gm")
    assert port.shapes == ref.shapes
    assert (MAX_Q, MAX_E) == (ref_pattern.MAX_Q, ref_pattern.MAX_E)


@pytest.mark.parametrize("shape", list(PatternArch.shapes))
def test_model_flops_match_reference(shape):
    got = get_config("rig_gm").model_flops(shape)
    assert got == ref_get_config("rig_gm").model_flops(shape)
    assert isinstance(got, float)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_smoke_matches_reference(seed, monkeypatch):
    from repro_torch.torchgm import frontier
    monkeypatch.setattr(frontier, "DEFAULT_DEVICE", "cpu")
    got = get_config("rig_gm").smoke(seed)
    want = ref_get_config("rig_gm").smoke(seed)
    assert got == want
    assert got["finite"] and got["count"] == got["host_count"]


def test_smoke_raises_without_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_config("rig_gm").smoke(0)


@pytest.mark.parametrize("shape", list(PatternArch.shapes))
def test_build_dryrun_unit_matches_reference(shape):
    """Each shape's unit on the (16, 16) production mesh (a fake group of
    256 ranks): its arguments' global shapes and dtypes (the packed uint32
    words as int32 lanes) and placements are the reference's
    ``ShapeDtypeStruct``s and specs; it runs on each rank's own tile."""
    from jax.sharding import AbstractMesh

    from repro_torch.dist.sharding import placements
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh

    ref = ref_get_config("rig_gm").build_dryrun(
        shape, AbstractMesh((16, 16), ("data", "model")))
    with fake_group(256):
        mesh = make_production_mesh()
        unit = get_config("rig_gm").build_dryrun(shape, mesh)
        assert unit.local and unit.name == ref.name
        args, specs = [], []
        for a, p in zip(unit.args, unit.placements):
            leaves = (list(vars(a).values()), list(vars(p).values())) \
                if hasattr(a, "labels") else ([a], [p])
            args += leaves[0]
            specs += leaves[1]
        ref_args = [x for a in ref.args for x in
                    (a.tree_flatten()[0] if hasattr(a, "tree_flatten")
                     else [a])]
        ref_specs = [x.spec for a in ref.in_shardings for x in
                     (a.tree_flatten()[0] if hasattr(a, "tree_flatten")
                      else [a])]
        assert len(args) == len(ref_args) == len(specs) == len(ref_specs)
        for got, want, pl, spec in zip(args, ref_args, specs, ref_specs):
            assert tuple(got.shape) == tuple(want.shape)
            assert str(got.dtype) == {"uint32": "torch.int32"}.get(
                str(want.dtype), f"torch.{want.dtype}")
            assert pl == placements(tuple(spec), mesh)
