"""What a step does with a value it reads on the host when it is traced
on ``meta`` tensors (the dry-run: shapes and dtypes, no values)."""

from __future__ import annotations

import torch


def host_int(t: torch.Tensor, traced: int) -> int:
    """``int(t)`` of a tensor with values; ``traced`` for a ``meta``
    tensor (also a DTensor of ``meta`` shards), whose value no trace
    knows.  ``traced`` is the value the reference's static program stands
    for, so that the trace runs the work that program runs."""
    return traced if t.is_meta else int(t)
