"""MoE dispatch and combine, dispatched on the operands' device.

The twin of the JAX package's ``kernels/moe_dispatch/ops.py``, without
``interpret``.  Each is a custom op (``repro_torch::moe_dispatch``,
``repro_torch::moe_combine``): a CPU tensor takes the plain PyTorch
version (``ref.py``); a CUDA tensor launches the hand-written kernel
(``moe_dispatch.py``), which raises if it cannot build or launch; a meta
or fake tensor takes the op's fake, which gives the output's shape and
type and computes nothing (the dry run traces a step through it).  There
is no fallback from one to the other.  Both move rows and do no
products, so neither has a FLOP formula.
"""
from __future__ import annotations

import torch

from .. import _build
from . import moe_dispatch as kernel
from . import ref


@torch.library.custom_op("repro_torch::moe_dispatch", mutates_args=(),
                         device_types="cpu")
def dispatch_op(x: torch.Tensor, slot: torch.Tensor,
                n_slots: int) -> torch.Tensor:
    """[n_slots, D] rows of x scattered to ``slot``: on a CPU tensor the
    plain version."""
    return ref.dispatch_ref(x, slot, n_slots)


@dispatch_op.register_kernel("cuda")
def _(x, slot, n_slots):
    return kernel.dispatch(x, slot, n_slots)


@dispatch_op.register_fake
def _(x, slot, n_slots):
    return x.new_empty((n_slots, x.shape[1]))


@torch.library.custom_op("repro_torch::moe_combine", mutates_args=(),
                         device_types="cpu")
def combine_op(ye: torch.Tensor, slot: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """[T, D] weighted sums of ye's rows at ``slot``: on a CPU tensor the
    plain version."""
    return ref.combine_ref(ye, slot, weights)


@combine_op.register_kernel("cuda")
def _(ye, slot, weights):
    return kernel.combine(ye, slot, weights)


@combine_op.register_fake
def _(ye, slot, weights):
    return ye.new_empty((slot.shape[0], ye.shape[1]))


def dispatch(x, slot, *, n_slots: int):
    """x [T, D]; slot [T] or [T, K] int32 in [0, n_slots) or -1 ->
    [n_slots, D]: row slot[t, k] holds x[t], the rest zero."""
    _build.refuse_dtensor("dispatch", x, slot)
    return dispatch_op(x, slot, n_slots)


def combine(ye, slot, weights):
    """ye [n_slots, D]; slot, weights [T, K] -> [T, D] in ye's type:
    sum_k w[t,k] ye[slot[t,k]] over the kept choices, in float32, the
    weights taken to float32 as the reference's kernel takes them."""
    _build.refuse_dtensor("combine", ye, slot, weights)
    return combine_op(ye, slot, weights.float())
