"""The CUDA flash-attention forward's wrapper (``csrc/flash_attention.cu``).

It checks its operands, allocates ``y`` and ``lse``, picks the kernel's
route (:func:`route`), launches on PyTorch's current stream without
synchronising, and raises if the launch is refused.  The kernel is built at
first use (:mod:`repro_torch.kernels._build`).
:attr:`flash_attention.launches` counts launches and nothing else, so a
training step can show that its attention went through the kernel;
:attr:`flash_attention.route_launches` counts them by route.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 head widths the wgmma kernel takes: multiples of 16 in [64, 128]
TENSOR_CORE_DIMS = tuple(range(64, 129, 16))
MAX_D = 256                       # the scalar kernel's widest head
_INT32_MAX = 2**31 - 1
# flash_attention_launch(dtype, tensor_cores, q, k, v, y, lse, bh, sq, sk,
# d, causal, window, q_offset, scale, stream)
ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = ARGTYPES
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def route(dtype: torch.dtype, d: int) -> str:
    """``"mma"`` (tensor cores: TMA and wgmma) for bf16 heads of 64, 80,
    96, 112 or 128, else ``"simt"`` (scalar f32 FMA)."""
    return ("mma" if dtype == torch.bfloat16 and d in TENSOR_CORE_DIMS
            else "simt")


def _check(q, k, v, window, q_offset) -> None:
    for name, t in dict(q=q, k=k, v=v).items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             f"every operand must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B,H,S,D]")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: q dtype {q.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share one dtype")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (GQA is expanded by the caller)")
    if (d * q.element_size()) % 16 or d > MAX_D:
        raise ValueError(f"flash_attention: a row of D={d} {q.dtype} must "
                         f"be a multiple of 16 bytes with D <= {MAX_D}")
    if q_offset < 0 or (window is not None and window < 0):
        raise ValueError(f"flash_attention: q_offset {q_offset} and window "
                         f"{window} must be >= 0")
    if b * h > _INT32_MAX or -(-sq // 32) > 65535 \
            or q_offset + sq > _INT32_MAX or k.shape[2] > _INT32_MAX:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} with "
                         f"q_offset {q_offset} is too large for one launch")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0):
    """Launch the kernel: q [B,H,Sq,D]; k, v [B,H,Sk,D] -> (y [B,H,Sq,D]
    in q's dtype, lse [B,H,Sq] float32); see ``ref.py`` for the function
    computed.  CUDA tensors only; raises on anything else."""
    _build.refuse_dtensor("flash_attention", q, k, v)
    _check(q, k, v, window, q_offset)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    use = route(q.dtype, d)
    y = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if y.numel() == 0 or sk == 0:
        y.zero_()
        lse.fill_(math.log(1e-20))
        return y, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            _DTYPE_CODES[q.dtype], int(use == "mma"),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
            lse.data_ptr(), b * h, sq, sk, d, int(causal),
            -1 if window is None else window, q_offset,
            1.0 / math.sqrt(d), stream)
    if err != 0:     # e.g. a refused launch: too much shared memory
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[use] += 1
    return y, lse


flash_attention.launches = 0
flash_attention.route_launches = {"mma": 0, "simt": 0}
