"""The CUDA SSD scan's wrapper (``csrc/ssd_scan.cu``).

It checks its operands, computes ``la = dt * -exp(a_log)`` (as the TPU
kernel's wrapper does), allocates ``y``, launches on PyTorch's current
stream without synchronising, and raises if the launch is refused.  The
kernel is built at first use (:mod:`repro_torch.kernels._build`).
:attr:`ssd_scan.launches` counts launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

MAX_DIM = 128                    # P and N the kernel takes
MAX_BATCH = 65_535               # the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# ssd_scan_launch(in_dtype, out_dtype, x, dt, la, b, c, d_skip, y, batch,
# seq, heads, p, n, stream)
ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = ARGTYPES
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def _check(xh, dt, a_log, b_mat, c_mat, d_skip, out_dtype) -> None:
    who = "ssd_scan"
    ops = dict(xh=xh, dt=dt, a_log=a_log, b_mat=b_mat, c_mat=c_mat,
               d_skip=d_skip)
    for name, t in ops.items():
        if t.device != xh.device or t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}; every operand "
                             f"must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if xh.dim() != 4:
        raise ValueError(f"{who}: xh must be [B,S,H,P], got "
                         f"{tuple(xh.shape)}")
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    shapes = dict(dt=(bsz, s, h), a_log=(h,), d_skip=(h,), b_mat=(bsz, s, n),
                  c_mat=(bsz, s, n))
    for name, want in shapes.items():
        if tuple(ops[name].shape) != want:
            raise ValueError(f"{who}: {name} is {tuple(ops[name].shape)}, "
                             f"want {want}")
    if xh.dtype not in _DTYPES or b_mat.dtype != xh.dtype \
            or c_mat.dtype != xh.dtype or out_dtype not in _DTYPES:
        raise ValueError(f"{who}: xh, b_mat and c_mat must share one dtype "
                         f"of {list(_DTYPES)} and y one of them; got "
                         f"{xh.dtype}, {b_mat.dtype}, {c_mat.dtype} -> "
                         f"{out_dtype}")
    for name in ("dt", "a_log", "d_skip"):
        if ops[name].dtype != torch.float32:
            raise ValueError(f"{who}: {name} must be float32")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"{who}: P={p} and N={n} must be in 1..{MAX_DIM}")
    if bsz > MAX_BATCH or xh.numel() >= 2**31 or b_mat.numel() >= 2**31:
        raise ValueError(f"{who}: shape {tuple(xh.shape)} is too large for "
                         f"one launch")


def ssd_scan(xh, dt, a_log, b_mat, c_mat, d_skip, *,
             out_dtype=None) -> torch.Tensor:
    """Launch the kernel: xh [B,S,H,P] and b/c [B,S,N] (float32 or
    bfloat16, one type); dt [B,S,H], a_log and d_skip [H] float32 -> y
    [B,S,H,P] in ``out_dtype`` (xh's type when None).  CUDA tensors only;
    raises on anything else."""
    out_dtype = xh.dtype if out_dtype is None else out_dtype
    _check(xh, dt, a_log, b_mat, c_mat, d_skip, out_dtype)
    bsz, s, h, p = xh.shape
    y = torch.empty(xh.shape, dtype=out_dtype, device=xh.device)
    if y.numel() == 0:
        return y
    la = dt * (-torch.exp(a_log))
    lib = _lib()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.ssd_scan_launch(
            _DTYPES[xh.dtype], _DTYPES[out_dtype], xh.data_ptr(),
            dt.data_ptr(), la.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
            d_skip.data_ptr(), y.data_ptr(), bsz, s, h, p, b_mat.shape[-1],
            stream)
    if err != 0:     # e.g. a refused launch: too much shared memory
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
