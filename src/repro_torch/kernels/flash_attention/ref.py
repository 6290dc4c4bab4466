"""Plain PyTorch blocked-attention forward: the kernel's reference version.

The twin of the JAX package's ``kernels/flash_attention/ref.py`` (one
softmax over the whole row, MHA layout: GQA is expanded by the caller),
extended to what the training path's forward returns
(``_blocked_fwd_impl`` in ``repro.models.layers``): the row log-sum-exp
``lse = m + log(max(l, 1e-20))``, with ``m`` taken as 0 for a row that sees
no key, and query positions shifted by ``q_offset``.  The CPU path of
:func:`..ops.attention` and the comparison ``chip_smoke.py`` holds the CUDA
kernel to on the card.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0):
    """q: [B,H,Sq,D]; k, v: [B,H,Sk,D] (same head counts) -> (y [B,H,Sq,D]
    in q's dtype, lse [B,H,Sq] float32).  Scores and softmax in float32;
    the normalised probabilities are cast to v's dtype for the product with
    V, as the JAX oracle does.  A row that sees no key gives y = 0."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    q_pos = q_offset + torch.arange(q.shape[2], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    del s
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    y = torch.matmul((p / l).to(v.dtype), v)
    lse = (m + torch.log(l)).squeeze(-1)
    return y.to(q.dtype), lse


KEY_TILE = 64   # keys per tile in both routes of csrc/flash_attention.cu


def attention_tiled(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0):
    """The same function in the CUDA kernel's order of work: keys in tiles
    of ``KEY_TILE``, a running row max, and the *unnormalised* ``p`` rounded to
    v's dtype before P.V, the output divided by ``max(l, 1e-20)`` and
    rounded once.  In bf16 it rounds where the kernel rounds, so the two
    differ only by float32 summation order; :func:`attention_ref` rounds
    the normalised ``p`` instead, which moves a short row by a bf16 ulp of
    ``|v|``.  Returns ``(y, lse, p_max)``; ``p_max`` [B,H,Sq] is the row's
    largest normalised probability, ``exp(m - lse)`` (0 where the row sees
    no key)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf = q.float()
    scale = 1.0 / math.sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
    l = torch.zeros(b, h, sq, 1, device=q.device)
    acc = torch.zeros(b, h, sq, v.shape[-1], device=q.device)
    for k0 in range(0, sk, KEY_TILE):
        k_pos = torch.arange(k0, min(k0 + KEY_TILE, sk), device=q.device)[None, :]
        s = torch.matmul(qf, k[:, :, k0:k0 + KEY_TILE].float().transpose(-1, -2))
        mask = torch.ones(sq, k_pos.shape[1], dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        s = (s * scale).masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.where(m == -math.inf, 0.0, torch.exp(m - m_safe))
        p = torch.where(s == -math.inf, 0.0, torch.exp(s - m_safe))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                        v[:, :, k0:k0 + KEY_TILE].float())
        m = m_new
    m = torch.where(m == -math.inf, 0.0, m)
    den = l.clamp_min(1e-20)
    lse = m + torch.log(den)
    p_max = torch.where(l > 0, torch.exp(m - lse), 0.0)
    return (acc / den).to(q.dtype), lse.squeeze(-1), p_max.squeeze(-1)
