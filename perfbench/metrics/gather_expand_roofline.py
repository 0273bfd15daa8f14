"""Kernels (``kernels/csrc/frontier_kernels.cu``): ``gather_expand``'s
share of its roofline (32-bit operations 67 T/s, HBM 3.35 TB/s) over the
traced window, where the enumerator calls it.  Each call's distinct
gathered rows are counted at their lower bound (1 where it gathers any),
so the share is never overstated."""

from ._roofline import share


def read(ctx):
    return share(ctx, "gather_expand")
