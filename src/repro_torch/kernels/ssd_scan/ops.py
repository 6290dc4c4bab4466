"""The SSD scan, dispatched on the operands' device.

The twin of the JAX package's ``kernels/ssd_scan/ops.py``, without
``interpret``.  The scan is the custom op ``repro_torch::ssd_scan``: a
CPU tensor takes the plain chunked version (``ref.py``); a CUDA tensor
launches the hand-written kernel (``ssd_scan.py``), which raises if it
cannot build or launch; a meta or fake tensor takes the op's fake, which
gives y's shape and type and computes nothing (the dry run traces a step
through it).  There is no fallback from one to the other.  The op's FLOP
formula counts the kernel's products (:func:`scan_flops`).
"""
from __future__ import annotations

import torch
from torch.utils import flop_counter

from .. import _build
from . import ref
from . import ssd_scan as kernel


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def ssd_op(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
           b_mat: torch.Tensor, c_mat: torch.Tensor, d_skip: torch.Tensor,
           chunk: int, out_dtype: torch.dtype) -> torch.Tensor:
    """y [B,S,H,P] in ``out_dtype``: on a CPU tensor the plain chunked
    version at ``chunk``."""
    return ref.ssd_chunked_ref(xh, dt, a_log, b_mat, c_mat, d_skip,
                               chunk=chunk).to(out_dtype)


@ssd_op.register_kernel("cuda")
def _(xh, dt, a_log, b_mat, c_mat, d_skip, chunk, out_dtype):
    return kernel.ssd_scan(xh, dt.float(), a_log.float(), b_mat, c_mat,
                           d_skip.float(), out_dtype=out_dtype)


@ssd_op.register_fake
def _(xh, dt, a_log, b_mat, c_mat, d_skip, chunk, out_dtype):
    return xh.new_empty(xh.shape, dtype=out_dtype)


def scan_flops(bsz: int, s: int, h: int, p: int, n: int) -> int:
    """The kernel's multiply-adds, times 2, for y [B,S,H,P] over a state
    of N: per head and sub-chunk of Q = ``ref.SUB_CHUNK`` rows, C.B^T
    (Q x Q x N) and its product with x (Q x Q x P), then C.state and the
    state update (Q x N x P each)."""
    q = ref.SUB_CHUNK
    return bsz * h * (2 * s * q * (n + p) + 4 * s * n * p)


if torch.ops.repro_torch.ssd_scan not in flop_counter.flop_registry:
    @flop_counter.register_flop_formula(torch.ops.repro_torch.ssd_scan)
    def _(xh_shape, dt_shape, a_shape, b_shape, c_shape, d_shape, chunk,
          out_dtype, *, out_shape=None, **kwargs) -> int:
        bsz, s, h, p = xh_shape
        return scan_flops(bsz, s, h, p, b_shape[-1])


def ssd(xh, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int = ref.SUB_CHUNK,
        out_dtype=None):
    """xh [B,S,H,P]; dt [B,S,H]; a_log, d_skip [H]; b/c [B,S,N] -> y
    [B,S,H,P] in ``out_dtype`` (xh's type when None, as the TPU kernel
    writes it).  ``chunk`` is the plain version's chunk length; the kernel
    walks 64-row sub-chunks whatever it is, which changes y only by
    float32 rounding."""
    _build.refuse_dtensor("ssd", xh, dt, a_log, b_mat, c_mat, d_skip)
    out_dtype = xh.dtype if out_dtype is None else out_dtype
    return ssd_op(xh, dt, a_log, b_mat, c_mat, d_skip, chunk, out_dtype)
