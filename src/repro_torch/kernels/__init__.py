# Hand-written CUDA kernels of the MJoin hot path, the whole-graph double
# simulation and the on-device closure, each with its plain PyTorch version
# beside it (ref.py) and a launch count (_build):
#   bitmm.bitmm                       — boolean matrix product, bit-packed
#                                       left operand (threshold or sum)
#   closure.closure_step              — R | (R·R > 0) on packed rows
#   gather_intersect.gather_intersect — resident-row gather + K-way AND +
#                                       popcount
#   gather_intersect.expand_pairs     — set bits -> (row, column) pages
#   gather_intersect.gather_expand    — one whole-graph enumerator level:
#                                       gather, AND, count, expand
#   intersect.intersect               — K-way AND + popcount of a slab
# The wrappers launch the kernels on CUDA tensors and run the plain
# versions on CPU tensors; the kernels are built at first use.  The
# wrappers are not re-exported here, so that the submodules keep their
# names.
from . import packed, ref
from ._build import launch_counts, reset_launch_counts

__all__ = ["packed", "ref", "launch_counts", "reset_launch_counts"]
