"""MoE token dispatch and combine: the CUDA kernels, their plain versions
and dispatch."""
