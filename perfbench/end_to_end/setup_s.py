"""Seconds from the start of the process to the start of the window:
imports, CUDA start, the weights drawn, kernels built or loaded, the
engine's caches, and the ramp that brings the traffic to a steady state."""


def read(ctx):
    return ctx.setup_s
