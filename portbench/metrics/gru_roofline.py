"""The gru kernels' share of their roofline, %."""

from portbench.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx, "gru")
