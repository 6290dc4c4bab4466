"""Paged decode attention: the CUDA kernel, its plain version and dispatch."""
