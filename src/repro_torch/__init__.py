"""PyTorch / CUDA port of the ``repro`` package for one NVIDIA Hopper card.

Each module here has a twin of the same path under ``repro``, which stays
the reference the tests hold this package against.  Nothing in this package
imports JAX or the reference package.  Entry points run on the card unless
the caller asks for the CPU (``device="cpu"``), where every kernel wrapper
takes its plain PyTorch version.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None; raises when the card
    is asked for and there is none (no silent CPU run)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "explicitly to run on the CPU")
    return device
