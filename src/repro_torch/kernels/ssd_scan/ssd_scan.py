"""The CUDA SSD scan's wrapper (``csrc/ssd_scan.cu``).

It checks its operands, allocates ``y``, picks the kernel's route
(:func:`route`), launches on PyTorch's current stream without
synchronising, and raises if the launch is refused.  The kernel computes
``la = dt * -exp(a_log)`` itself (the TPU kernel's wrapper does it
outside).  The kernel is built at first use
(:mod:`repro_torch.kernels._build`).  :attr:`ssd_scan.launches` counts
launches of either route and nothing else; ``ssd_scan.route_launches``
counts them by route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

MAX_DIM = 128                    # P and N the scalar kernel takes
TENSOR_CORE_DIMS = (64, 128)     # P and N the bf16 mma kernel takes
MAX_BATCH = 65_535               # the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"simt": 0, "mma": 1}
# ssd_scan_launch(route, in_dtype, out_dtype, x, dt, a_log, b, c, d_skip,
# y, batch, seq, heads, p, n, stream)
ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = ARGTYPES
    lib.ssd_scan_launch.restype = ctypes.c_int
    return lib


def route(dtype: torch.dtype, p: int, n: int) -> str:
    """``"mma"`` (tensor cores: split-bf16 ``mma.sync``, the state in
    registers) for bf16 x/B/C with P and N each 64 or 128, else ``"simt"``
    (scalar f32 FMA)."""
    return ("mma" if dtype == torch.bfloat16 and p in TENSOR_CORE_DIMS
            and n in TENSOR_CORE_DIMS else "simt")


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


def ssd_scan(xh, dt, a_log, b_mat, c_mat, d_skip, *, out_dtype=None,
             use: str | None = None) -> torch.Tensor:
    """Launch the kernel: xh [B,S,H,P] and b/c [B,S,N] (float32 or
    bfloat16, one type); dt [B,S,H], a_log and d_skip [H] float32 -> y
    [B,S,H,P] in ``out_dtype`` (xh's type when None), on the route
    :func:`route` names, or on ``use="simt"`` (any operands the scalar
    kernel takes: to time it against the other).  CUDA tensors only;
    raises on anything else."""
    _build.refuse_dtensor("ssd_scan", xh, dt, a_log, b_mat, c_mat, d_skip)
    out_dtype = xh.dtype if out_dtype is None else out_dtype
    _check(xh, dt, a_log, b_mat, c_mat, d_skip, out_dtype)
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    which = route(xh.dtype, p, n)
    if use not in (None, "simt", which):
        raise ValueError(f"ssd_scan: route {use!r} does not take these "
                         f"operands (they take {which!r})")
    which = use or which
    if which == "mma" and any(t.data_ptr() % 16 for t in (xh, b_mat, c_mat)):
        raise ValueError("ssd_scan: the mma route loads xh, b_mat and c_mat "
                         "16 bytes at a time; they must be 16-byte aligned")
    y = torch.empty(xh.shape, dtype=out_dtype, device=xh.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.ssd_scan_launch(
            _ROUTES[which], _DTYPES[xh.dtype], _DTYPES[out_dtype],
            xh.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), d_skip.data_ptr(),
            y.data_ptr(), bsz, s, h, p, n, stream)
    if err != 0:     # e.g. a refused launch: too much shared memory
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    ssd_scan.route_launches[which] += 1
    return y


ssd_scan.launches = 0
ssd_scan.route_launches = {"simt": 0, "mma": 0}
