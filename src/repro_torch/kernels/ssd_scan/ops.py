"""The SSD scan, dispatched on the operands' device.

The twin of the JAX package's ``kernels/ssd_scan/ops.py``, without
``interpret``.  A CPU tensor takes the plain chunked version (``ref.py``);
a CUDA tensor launches the hand-written kernel (``ssd_scan.py``), which
raises if it cannot build or launch.  There is no fallback from one to the
other.
"""
from __future__ import annotations

from . import ref
from . import ssd_scan as kernel


def ssd(xh, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int = ref.SUB_CHUNK,
        out_dtype=None):
    """xh [B,S,H,P]; dt [B,S,H]; a_log, d_skip [H]; b/c [B,S,N] -> y
    [B,S,H,P] in ``out_dtype`` (xh's type when None, as the TPU kernel
    writes it).  ``chunk`` is the plain version's chunk length; the kernel
    walks 64-row sub-chunks whatever it is, which changes y only by
    float32 rounding."""
    out_dtype = xh.dtype if out_dtype is None else out_dtype
    if xh.device.type == "cpu":
        return ref.ssd_chunked_ref(xh, dt, a_log, b_mat, c_mat, d_skip,
                                   chunk=chunk).to(out_dtype)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {xh.device}")
    return kernel.ssd_scan(xh, dt.float(), a_log.float(), b_mat, c_mat,
                           d_skip.float(), out_dtype=out_dtype)
