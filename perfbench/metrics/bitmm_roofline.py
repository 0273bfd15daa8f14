"""Kernels (``kernels/csrc/bitmm.cu``): ``bitmm``'s share of its roofline
(int8 tensor cores 1,979 TOP/s, HBM 3.35 TB/s) over the traced window."""

from ._roofline import share


def read(ctx):
    return share(ctx, "bitmm")
