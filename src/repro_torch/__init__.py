"""PyTorch / CUDA port of the ``repro`` package for one NVIDIA Hopper card.

Each module here has a twin of the same path under ``repro``, which stays
the reference the tests hold this package against.  Nothing in this package
imports JAX or the reference package.  Entry points run on the card unless
the caller asks for the CPU (``device="cpu"``), where every kernel wrapper
takes its plain PyTorch version.
"""
