"""Blocked attention forward, dispatched on the operands' device.

The twin of the JAX package's ``kernels/flash_attention/ops.py``: GQA KV is
expanded to the query heads by repeat, then the custom op
``repro_torch::flash_attention`` runs: a CPU tensor takes the plain
PyTorch version (``ref.py``), a CUDA tensor launches the hand-written
kernel (``flash_attention.py``), which raises if it cannot build or
launch, and a meta or fake tensor takes the op's fake, which gives the
outputs' shapes and types and computes nothing (the dry run traces a
step through it).  There is no fallback from one to the other.  The op's
FLOP formula counts the kernel's work: the products of the key-query
pairs that the mask keeps.
"""
from __future__ import annotations

import torch
from torch.utils import flop_counter

from .. import _build
from . import flash_attention as kernel
from . import ref


def _operand(t):
    """Contiguous and 16-byte aligned, as the kernel takes it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int | None, q_offset: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, lse) of q [B,H,Sq,D] over k, v [B,H,Sk,D]: on a CPU tensor the
    plain version."""
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)


@flash_op.register_kernel("cuda")
def _(q, k, v, causal, window, q_offset):
    return kernel.flash_attention(_operand(q), _operand(k), _operand(v),
                                  causal=causal, window=window,
                                  q_offset=q_offset)


@flash_op.register_fake
def _(q, k, v, causal, window, q_offset):
    b, h, sq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq), dtype=torch.float32))


def kept_pairs(sq: int, sk: int, causal: bool, window: int | None,
               q_offset: int) -> int:
    """The (query, key) pairs of one head that the mask keeps: the query at
    position p = q_offset + i sees key j when j <= p (causal) and
    p - j < window, as ``ref.attention_ref`` masks."""
    p = torch.arange(q_offset, q_offset + sq, dtype=torch.int64)
    hi = (p + 1).clamp(max=sk) if causal else torch.full_like(p, sk)
    lo = (p - window + 1).clamp(min=0) if window is not None else 0
    return int((hi - lo).clamp(min=0).sum())


if torch.ops.repro_torch.flash_attention not in flop_counter.flop_registry:
    @flop_counter.register_flop_formula(
        torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, q_offset, *,
          out_shape=None, **kwargs) -> int:
        """2 products (q.k and p.v) of D multiply-adds a kept pair."""
        b, h, sq, d = q_shape
        return 4 * b * h * d * kept_pairs(sq, k_shape[2], causal, window,
                                          q_offset)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, return_lse: bool = False):
    """q: [B,Hq,Sq,D]; k, v: [B,Hkv,Sk,D] with Hq % Hkv == 0 -> y
    [B,Hq,Sq,D] (and lse [B,Hq,Sq] float32 with ``return_lse``)."""
    _build.refuse_dtensor("attention", q, k, v)
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    y, lse = flash_op(q, k, v, causal, window, q_offset)
    return (y, lse) if return_lse else y
