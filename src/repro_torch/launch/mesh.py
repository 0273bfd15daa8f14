"""Production mesh builders over ``torch.distributed``.

Functions (never module-level state): each returns a
``torch.distributed.device_mesh.DeviceMesh`` with the axis names that
:mod:`repro_torch.torchgm.distributed` shards over, ``("data", "model")``
or ``("pod", "data", "model")``, laid row-major over the ranks (rank =
pod * n_data * n_model + data * n_model + model).

The mesh's device is the port's device
(:func:`repro_torch.torchgm.frontier.resolve`): the card unless the CPU is
pinned.  Its backend is NCCL on the card and gloo on a pinned CPU; a group
on the other backend raises, never a quiet switch.  The mesh sits over the
process group the caller started (``torchrun``, spawned ranks with a
store); only a 1 x 1 local mesh with no group starts one itself, a
one-process group on an in-memory ``HashStore`` (no environment variables,
no network).  Over a ``fake`` process group (``launch.dryrun``) the mesh
is a ``cuda`` mesh on any machine and the port's device is not read.  On
a group of several ranks on the card, each rank first
takes its own card (``LOCAL_RANK``, else its rank modulo the cards) unless
the caller pinned a device: the port's device is read from the current
card, which ``init_device_mesh`` would otherwise leave at card 0.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..torchgm import frontier


def _device() -> torch.device:
    """The port's device; on a group of several ranks and no pinned
    device, this rank's own card, set before anything reads the current
    one."""
    if (frontier.DEFAULT_DEVICE is None and dist.is_initialized()
            and dist.get_world_size() > 1 and torch.cuda.is_available()):
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return frontier.resolve()


def _mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    if dist.is_initialized() and dist.get_backend() == "fake":
        return _fake_mesh(shape, axes)
    dev = _device()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a {tuple(shape)} mesh needs a process group of {size} "
                f"ranks: start one first (torchrun, or "
                f"init_process_group with a store)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif backend not in str(dist.get_backend()):
        raise RuntimeError(f"the process group runs {dist.get_backend()}; a "
                           f"mesh on {dev.type} needs {backend}")
    if dist.get_world_size() != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _fake_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """The mesh over a ``fake`` process group (the dry-run's): a ``cuda``
    mesh on any machine, since the dry-run models the card; no card is
    touched and the port's device is not read."""
    size = math.prod(shape)
    if dist.get_world_size() != size:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks, the "
                         f"fake process group has {dist.get_world_size()}")
    return init_device_mesh("cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the caller's process group, or over a
    one-process group that it starts when there is none and the mesh is
    1 x 1."""
    return _mesh((data, model), ("data", "model"))
