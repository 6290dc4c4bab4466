"""The CUDA paged-attention kernel's wrapper (``csrc/paged_attention.cu``).

It checks its operands, allocates the output, launches on PyTorch's current
stream without synchronising, and raises if the launch is refused.  The
kernel is built at first use (:mod:`repro_torch.kernels._build`).
:attr:`paged_attention.launches` counts launches and nothing else, so a run
can show that its decode steps went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def _check(q, k_pages, v_pages, page_table, lengths) -> None:
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   page_table=page_table, lengths=lengths)
    for name, t in tensors.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"paged_attention: {name} is on {t.device}; "
                             f"every operand must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention: q dtype {q.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_attention: q, k_pages and v_pages must share "
                         "one dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and lengths must be "
                         "int32")
    if q.dim() != 3 or k_pages.dim() != 4 or page_table.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError("paged_attention: want q [B,H,D], pages "
                         "[N,page,Hkv,D], page_table [B,P], lengths [B]")
    b, h, d = q.shape
    _, page, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d \
            or page_table.shape[0] != b or lengths.shape[0] != b:
        raise ValueError(f"paged_attention: shapes disagree: q {tuple(q.shape)}"
                         f", pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}, page_table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"paged_attention: H={h} is not a multiple of "
                         f"Hkv={hkv}")
    if (d * q.element_size()) % 16:
        raise ValueError(f"paged_attention: a row of D={d} {q.dtype} is not "
                         f"a multiple of 16 bytes")


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """Launch the kernel: q [B,H,D]; pages [N,page,Hkv,D]; page_table [B,P]
    int32; lengths [B] int32 -> [B,H,D] in q's dtype (see ``ref.py`` for
    the function computed).  CUDA tensors only; raises on anything else."""
    _check(q, k_pages, v_pages, page_table, lengths)
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, hkv, d, page, page_table.shape[1], stream)
    if err != 0:     # e.g. a refused launch: too much shared memory
        raise RuntimeError(f"paged_attention: kernel launch failed with CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
