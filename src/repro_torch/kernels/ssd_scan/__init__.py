"""Mamba-2 SSD chunked scan: the CUDA kernel, its plain versions and
dispatch."""
