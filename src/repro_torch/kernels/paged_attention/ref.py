"""Plain PyTorch paged decode attention: the kernel's reference version.

The twin of the JAX package's ``kernels/paged_attention/ref.py``, with
grouped-query heads read natively (query head ``h`` reads KV head
``h // (H // Hkv)``).  The CPU path of :func:`..ops.paged_attention` and the
comparison ``chip_smoke.py`` holds the CUDA kernel to on the card.
"""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """Single-token decode over paged KV.

    q:          [B, H, D]
    k_pages:    [n_pages, page_size, Hkv, D] (physical page pool), H % Hkv == 0
    v_pages:    same
    page_table: [B, pages_per_seq] int32 physical page id per logical page
    lengths:    [B] int32 valid tokens per sequence (clamped to the table)

    Returns [B, H, D] in q's dtype.  Scores, softmax and the P.V sum run in
    float32; a zero-length row gives zeros.  Table entries of logical pages
    past ``ceil(length / page)`` are not read.
    """
    b, h, d = q.shape
    _, page, hkv, _ = k_pages.shape
    pps = page_table.shape[1]
    rep = h // hkv
    lengths = lengths.long()
    logical = torch.arange(pps, device=q.device)
    live = logical[None, :] * page < lengths[:, None]            # [B, P]
    table = torch.where(live, page_table.long(), 0)
    kg = k_pages[table].reshape(b, pps * page, hkv, d).float()   # [B, S, Hkv, D]
    vg = v_pages[table].reshape(b, pps * page, hkv, d).float()
    qg = q.float().reshape(b, hkv, rep, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, kg) / math.sqrt(d)
    pos = torch.arange(pps * page, device=q.device)
    valid = (pos[None, :] < lengths[:, None])[:, None, None, :]  # [B,1,1,S]
    s = s.masked_fill(~valid, -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(valid, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    y = torch.einsum("bgrs,bsgd->bgrd", p, vg)
    return y.reshape(b, h, d).to(q.dtype)
