"""PyTorch/CUDA port of the RIG-based graph pattern matcher.

The host pipeline (transitive reduction, double simulation, BuildRIG,
ordering, MJoin) lives in :mod:`repro_torch.core` and runs in numpy; the
MJoin constraint work runs on an NVIDIA GPU through the hand-written CUDA
kernels of :mod:`repro_torch.kernels`, driven by the executors of
:mod:`repro_torch.torchgm`.  Entry points run on the card: without CUDA
they raise unless the caller pins the CPU
(``repro_torch.torchgm.frontier.DEFAULT_DEVICE = "cpu"``).
"""

from .core import GM, GMOptions, MatchResult, MatchStream, match

__all__ = ["GM", "GMOptions", "MatchResult", "MatchStream", "match"]
