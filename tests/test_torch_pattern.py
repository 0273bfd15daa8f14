"""The port's ``rig_gm`` arch (``repro_torch.configs.pattern``) and the
registry against the JAX package's, on the CPU: shapes, ``model_flops``
for every shape, the smoke's dict for four seeds (``TorchGM`` on the
kernels' plain versions against the reference's ``JaxGM``), and what is
still to port raising."""

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
def test_build_dryrun_names_its_part(shape):
    with pytest.raises(NotImplementedError,
                       match=f"rig_gm:{shape}.*part 9.3"):
        get_config("rig_gm").build_dryrun(shape, None)
