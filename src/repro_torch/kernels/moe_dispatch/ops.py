"""MoE dispatch and combine, dispatched on the operands' device.

The twin of the JAX package's ``kernels/moe_dispatch/ops.py``, without
``interpret``.  A CPU tensor takes the plain PyTorch version (``ref.py``);
a CUDA tensor launches the hand-written kernel (``moe_dispatch.py``),
which raises if it cannot build or launch.  There is no fallback from one
to the other.
"""
from __future__ import annotations

from . import moe_dispatch as kernel
from . import ref


def dispatch(x, slot, *, n_slots: int):
    """x [T, D]; slot [T] or [T, K] int32 in [0, n_slots) or -1 ->
    [n_slots, D]: row slot[t, k] holds x[t], the rest zero."""
    if x.device.type == "cpu":
        return ref.dispatch_ref(x, slot, n_slots)
    if x.device.type != "cuda":
        raise ValueError(f"dispatch: no kernel for device {x.device}")
    return kernel.dispatch(x, slot, n_slots)


def combine(ye, slot, weights):
    """ye [n_slots, D]; slot, weights [T, K] -> [T, D] in ye's type:
    sum_k w[t,k] ye[slot[t,k]] over the kept choices, in float32, the
    weights taken to float32 as the reference's kernel takes them."""
    if ye.device.type == "cpu":
        return ref.combine_ref(ye, slot, weights)
    if ye.device.type != "cuda":
        raise ValueError(f"combine: no kernel for device {ye.device}")
    return kernel.combine(ye, slot, weights.float())
