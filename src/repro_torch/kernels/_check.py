"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def lanes(t: torch.Tensor, name: str, ndim: int) -> None:
    """``t`` must be a contiguous int32 lane tensor of rank ``ndim``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 lanes (an int32 view of the "
                        f"packed uint32 words), got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def aligned(t: torch.Tensor, name: str, nbytes: int) -> None:
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must start on a {nbytes}-byte boundary")
