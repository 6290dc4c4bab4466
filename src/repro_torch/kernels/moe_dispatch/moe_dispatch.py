"""Wrappers of the CUDA MoE dispatch and combine kernels
(``csrc/moe_dispatch.cu``).

Each wrapper checks its operands, allocates the output, launches on
PyTorch's current stream without synchronising, and raises if the launch
is refused.  The library is built at first use
(:mod:`repro_torch.kernels._build`).  Each wrapper's ``launches``
attribute counts its launches and nothing else.  The contract on slots is
that kept ones are distinct and lie in [0, n_slots), as in the JAX
package; it is not checked, since that would cost a synchronisation with
the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

MAX_FANIN = 8                    # K the kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# moe_dispatch_launch(x, slot, out, tokens, fanin, row_bytes, n_slots,
# stream)
DISPATCH_ARGTYPES = [_ptr] * 3 + [_i32] * 4 + [_ptr]
# moe_combine_launch(dtype, ye, slot, w, y, tokens, fanin, row_bytes, stream)
COMBINE_ARGTYPES = [_i32] + [_ptr] * 4 + [_i32] * 3 + [_ptr]
# moe_combine_parts(tokens, row_bytes)
PARTS_ARGTYPES = [_i32, _i32]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_dispatch")
    lib.moe_dispatch_launch.argtypes = DISPATCH_ARGTYPES
    lib.moe_combine_launch.argtypes = COMBINE_ARGTYPES
    lib.moe_combine_parts.argtypes = PARTS_ARGTYPES
    lib.moe_dispatch_launch.restype = ctypes.c_int
    lib.moe_combine_launch.restype = ctypes.c_int
    lib.moe_combine_parts.restype = ctypes.c_int
    return lib


def _check_device(who: str, **tensors) -> torch.device:
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}; every operand "
                             f"must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    return device


def _check_rows(who: str, name: str, t: torch.Tensor) -> int:
    """Row bytes of a 2-D tensor whose rows the kernels move in 16-byte
    chunks."""
    if t.dim() != 2:
        raise ValueError(f"{who}: {name} must be 2-D, got {tuple(t.shape)}")
    row_bytes = t.shape[1] * t.element_size()
    if row_bytes % 16 or row_bytes == 0:
        raise ValueError(f"{who}: a row of D={t.shape[1]} {t.dtype} is "
                         f"{row_bytes} bytes, not a positive multiple of 16: "
                         f"the kernels move rows in 16-byte chunks")
    if t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must start on a 16-byte boundary")
    return row_bytes


def _check_slots(who: str, slot: torch.Tensor, tokens: int) -> int:
    """The fan-in K, 1..MAX_FANIN, of an int32 slot tensor [T] (K = 1) or
    [T, K]."""
    if slot.dtype != torch.int32 or slot.dim() not in (1, 2) \
            or slot.shape[0] != tokens:
        raise ValueError(f"{who}: slot must be int32 [T] or [T, K] with "
                         f"T={tokens}, got {slot.dim()}-D {slot.dtype} "
                         f"{tuple(slot.shape)}")
    if slot.numel() > _INT32_MAX:
        raise ValueError(f"{who}: {slot.numel()} slots; at most 2**31 - 1")
    fanin = 1 if slot.dim() == 1 else slot.shape[1]
    if not 1 <= fanin <= MAX_FANIN:
        raise ValueError(f"{who}: fan-in K={fanin} not in 1..{MAX_FANIN}")
    return fanin


def _raise_on(who: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dispatch(x: torch.Tensor, slot: torch.Tensor,
             n_slots: int) -> torch.Tensor:
    """out[slot[t, k]] = x[t] for every kept choice; the other rows zero.
    x [T, D] (rows a multiple of 16 bytes); slot int32 [T] or [T, K],
    K <= 8 -> [n_slots, D]."""
    who = "moe_dispatch"
    _build.refuse_dtensor(who, x, slot)
    device = _check_device(who, x=x, slot=slot)
    row_bytes = _check_rows(who, "x", x)
    fanin = _check_slots(who, slot, x.shape[0])
    if not 0 <= n_slots <= _INT32_MAX:
        raise ValueError(f"{who}: n_slots={n_slots} not in 0..2**31 - 1")
    out = torch.empty((n_slots, x.shape[1]), dtype=x.dtype, device=device)
    if n_slots == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().moe_dispatch_launch(
            x.data_ptr(), slot.data_ptr(), out.data_ptr(), x.shape[0], fanin,
            row_bytes, n_slots, _stream(device))
    _raise_on(who, err)
    dispatch.launches += 1
    return out


def combine(ye: torch.Tensor, slot: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_k w[t,k] ye[slot[t,k]] over the kept choices, in float32
    in k order, cast to ye's type.  Each token's row is split over
    :func:`combine_parts` blocks, enough to fill the card when the tokens
    are few.  ye [n_slots, D] float32 or bfloat16; slot int32 and weights
    float32 [T, K], K <= 8 -> [T, D]."""
    who = "moe_combine"
    _build.refuse_dtensor(who, ye, slot, weights)
    device = _check_device(who, ye=ye, slot=slot, weights=weights)
    row_bytes = _check_rows(who, "ye", ye)
    if slot.dim() != 2:
        raise ValueError(f"{who}: slot must be [T, K], got "
                         f"{tuple(slot.shape)}")
    fanin = _check_slots(who, slot, slot.shape[0])
    if ye.dtype not in _DTYPES or weights.dtype != torch.float32:
        raise ValueError(f"{who}: want ye in {list(_DTYPES)} and float32 "
                         f"weights, got {ye.dtype} and {weights.dtype}")
    if weights.shape != slot.shape:
        raise ValueError(f"{who}: weights {tuple(weights.shape)} != slot "
                         f"{tuple(slot.shape)}")
    tokens = slot.shape[0]
    out = torch.empty((tokens, ye.shape[1]), dtype=ye.dtype, device=device)
    if tokens == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().moe_combine_launch(
            _DTYPES[ye.dtype], ye.data_ptr(), slot.data_ptr(),
            weights.data_ptr(), out.data_ptr(), tokens, fanin, row_bytes,
            _stream(device))
    _raise_on(who, err)
    combine.launches += 1
    return out


def combine_parts(tokens: int, row_bytes: int) -> int:
    """The blocks that :func:`combine` splits each of ``tokens`` rows of
    ``row_bytes`` into (the launch's own arithmetic; builds the library)."""
    if tokens < 1 or row_bytes < 16 or row_bytes % 16:
        raise ValueError(f"combine_parts: want tokens >= 1 and rows of a "
                         f"positive multiple of 16 bytes, got {tokens} and "
                         f"{row_bytes}")
    return _lib().moe_combine_parts(tokens, row_bytes)


dispatch.launches = 0
combine.launches = 0
