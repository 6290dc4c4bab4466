"""Blocked attention forward, dispatched on the operands' device.

The twin of the JAX package's ``kernels/flash_attention/ops.py``: GQA KV is
expanded to the query heads by repeat, then a CPU tensor takes the plain
PyTorch version (``ref.py``) and a CUDA tensor launches the hand-written
kernel (``flash_attention.py``), which raises if it cannot build or launch.
There is no fallback from one to the other.
"""
from __future__ import annotations

from . import flash_attention as kernel
from . import ref


def _operand(t):
    """Contiguous and 16-byte aligned, as the kernel takes it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, return_lse: bool = False):
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Sk,D] with Hq % Hkv == 0 -> y
    [B,Hq,Sq,D] (and lse [B,Hq,Sq] float32 with ``return_lse``)."""
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if q.device.type == "cpu":
        y, lse = ref.attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    elif q.device.type == "cuda":
        y, lse = kernel.flash_attention(_operand(q), _operand(k), _operand(v),
                                        causal=causal, window=window,
                                        q_offset=q_offset)
    else:
        raise ValueError(f"attention: no kernel for device {q.device}")
    return (y, lse) if return_lse else y
