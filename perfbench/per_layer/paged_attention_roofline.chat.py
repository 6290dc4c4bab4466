"""The paged-attention kernel's share of its roofline in traced decode
steps: the bytes and FLOPs the active slots need at their served lengths,
over the device time of the kernels named here."""
from perfbench.readers import paged_attention_roofline

KERNELS = ("paged_partition_kernel", "paged_merge_kernel")


def read(ctx):
    return paged_attention_roofline(ctx, KERNELS)
