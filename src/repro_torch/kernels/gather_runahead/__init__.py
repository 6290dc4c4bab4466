"""Runahead row gathers and the Listing-1 gather-bag: the CUDA kernels,
their plain versions and dispatch."""
