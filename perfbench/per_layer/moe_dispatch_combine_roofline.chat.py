"""The MoE dispatch and combine kernels' share of their roofline in traced
steps: the bytes the routed rows need, over the device time of the kernels
named here."""
from perfbench.readers import dispatch_combine_roofline

KERNELS = ("dispatch_kernel", "combine_kernel")


def read(ctx):
    return dispatch_combine_roofline(ctx, KERNELS)
