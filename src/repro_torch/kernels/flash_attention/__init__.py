"""Blocked (flash) attention forward: the CUDA kernel, its plain version
and dispatch."""
