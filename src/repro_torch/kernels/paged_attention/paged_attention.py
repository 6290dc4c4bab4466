"""The CUDA paged-attention kernel's wrapper (``csrc/paged_attention.cu``).

It checks its operands, picks how many blocks split each row's pages
(:func:`n_splits`), allocates the output and the split partials, launches
the partition and merge passes on PyTorch's current stream without
synchronising, and raises if a launch is refused.  The kernels are built at
first use (:mod:`repro_torch.kernels._build`).
:attr:`paged_attention.launches` counts wrapper calls that launched (one
per call, though a call is two CUDA launches) and nothing else, so a run
can show that its decode steps went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_TOKENS = 64     # keys a partition block loads at once, at most
SMS = 132             # the H100's streaming multiprocessors
MAX_ROW_BYTES = 1024  # the kernel's widest K/V row (64 chunks of 16 bytes)
# paged_attention_launch(dtype, q, k_pages, v_pages, page_table, lengths,
# out, scratch, B, H, Hkv, D, page, P, n_split, kv_stride, kv0, stream)
ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_void_p])


def n_splits(b: int, hkv: int, pages_per_seq: int, page: int) -> int:
    """How many blocks split each row's page loop: runs of
    ``ceil(pages_per_seq / n)`` pages.  Starts from runs of SPLIT_TOKENS
    keys (at least one page) and halves the run while the grid of
    ``b * hkv * n`` blocks is short of one wave on the card's SMs.  A pure
    function of shapes the host knows, never of ``lengths``, so the launch
    needs no device sync; the plain split version takes the same count.
    ``hkv`` is the pool's, also for a call that reads a run of its heads."""
    run = max(1, SPLIT_TOKENS // page)
    while run > 1 and b * hkv * -(-pages_per_seq // run) < SMS:
        run //= 2
    return -(-pages_per_seq // run)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    lib.paged_attention_launch.argtypes = ARGTYPES
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def _check(q, k_pages, v_pages, page_table, lengths, kv_head0,
           kv_heads) -> None:
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   page_table=page_table, lengths=lengths)
    for name, t in tensors.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"paged_attention: {name} is on {t.device}; "
                             f"every operand must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             f"aligned")
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
    kv_heads = hkv if kv_heads is None else kv_heads
    if not (kv_heads >= 1 and 0 <= kv_head0 and kv_head0 + kv_heads <= hkv):
        raise ValueError(f"paged_attention: KV heads [{kv_head0}, "
                         f"{kv_head0 + kv_heads}) are not in the pool's "
                         f"{hkv}")
    if h % kv_heads:
        raise ValueError(f"paged_attention: H={h} is not a multiple of "
                         f"the {kv_heads} KV heads read")
    if (d * q.element_size()) % 16 or d * q.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"paged_attention: a row of D={d} {q.dtype} must be "
                         f"a multiple of 16 bytes, at most {MAX_ROW_BYTES}")
    if page_table.shape[1] < 1 or page < 1:
        raise ValueError("paged_attention: the page table and the pages "
                         "must not be empty")


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    kv_head0: int = 0, kv_heads: int | None = None):
    """Launch the kernel: q [B,H,D]; pages [N,page,Hkv,D]; page_table [B,P]
    int32; lengths [B] int32 -> [B,H,D] in q's dtype (see ``ref.py`` for
    the function computed).  CUDA tensors only; raises on anything else.

    ``kv_head0`` and ``kv_heads`` (all of the pool's by default) name the
    run of KV heads that q's heads read, for one tensor-parallel shard's
    query heads; the split count is the whole pool's call's, so a shard's
    heads come out bit for bit as in the unsharded call."""
    _build.refuse_dtensor("paged_attention", q, k_pages, v_pages, page_table,
                          lengths)
    _check(q, k_pages, v_pages, page_table, lengths, kv_head0, kv_heads)
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    kv_heads = hkv if kv_heads is None else kv_heads
    p = page_table.shape[1]
    n = n_splits(b, hkv, p, page)
    out = torch.empty_like(q)
    # per (sequence, head, split): acc[D], then (m, l) after all the accs
    scratch = torch.empty(b * h * n * (d + 2), dtype=torch.float32,
                          device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, h, kv_heads, d, page, p,
            n, hkv, kv_head0, stream)
    if err != 0:     # e.g. a refused launch: too much shared memory
        raise RuntimeError(f"paged_attention: kernel launch failed with CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
