"""Plain PyTorch paged decode attention: the kernel's reference version.

The twin of the JAX package's ``kernels/paged_attention/ref.py``, with
grouped-query heads read natively (query head ``h`` reads KV head
``h // (H // Hkv)``).  The CPU path of :func:`..ops.paged_attention` and the
comparison ``chip_smoke.py`` holds the CUDA kernel to on the card.
"""
from __future__ import annotations

import math

import torch


def _heads(k_pages, table, kv_head0: int, kv_heads):
    """Pages of ``table`` [B, P] as [B, P * page, n, D] float32 over KV
    heads [kv_head0, kv_head0 + n) (all of them when ``kv_heads`` is
    None)."""
    _, page, hkv, d = k_pages.shape
    n = hkv if kv_heads is None else kv_heads
    rows = k_pages[table][..., kv_head0:kv_head0 + n, :]
    return rows.reshape(table.shape[0], -1, n, d).float()


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        kv_head0: int = 0, kv_heads: int | None = None):
    """Single-token decode over paged KV.

    q:          [B, H, D]
    k_pages:    [n_pages, page_size, Hkv, D] (physical page pool), H % Hkv == 0
    v_pages:    same
    page_table: [B, pages_per_seq] int32 physical page id per logical page
    lengths:    [B] int32 valid tokens per sequence (clamped to the table)

    Returns [B, H, D] in q's dtype.  Scores, softmax and the P.V sum run in
    float32; a zero-length row gives zeros.  Table entries of logical pages
    past ``ceil(length / page)`` are not read.  ``kv_head0`` and
    ``kv_heads`` name the run of the pool's KV heads that q's H heads
    read (one tensor-parallel shard's), all of them by default.
    """
    b, h, d = q.shape
    _, page, _, _ = k_pages.shape
    pps = page_table.shape[1]
    lengths = lengths.long()
    logical = torch.arange(pps, device=q.device)
    live = logical[None, :] * page < lengths[:, None]            # [B, P]
    table = torch.where(live, page_table.long(), 0)
    kg = _heads(k_pages, table, kv_head0, kv_heads)              # [B, S, Hkv, D]
    vg = _heads(v_pages, table, kv_head0, kv_heads)
    hkv = kg.shape[2]
    rep = h // hkv
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


def paged_attention_split(q, k_pages, v_pages, page_table, lengths,
                          n_split: int, *, kv_head0: int = 0,
                          kv_heads: int | None = None):
    """The same function in the CUDA kernel's order of work: each row's
    page loop cut into ``n_split`` runs of ``ceil(P / n_split)`` pages
    (the count the wrapper's ``n_splits`` gives the kernel); per run and
    head an f32 max ``m``, sum ``l`` and unnormalised ``acc``, a run past
    the row's length empty (``m = -inf``, ``l = 0``); the runs merged as
    ``sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-20)`` with an
    empty run weighing 0, and the output rounded once.  The kernel and this
    version then differ only by float32 summation order."""
    b, h, d = q.shape
    _, page, _, _ = k_pages.shape
    pps = page_table.shape[1]
    run = -(-pps // n_split) * page                 # tokens a split
    span = n_split * run
    lengths = lengths.long().clamp(0, pps * page)
    logical = torch.arange(pps, device=q.device)
    live = logical[None, :] * page < lengths[:, None]
    table = torch.where(live, page_table.long(), 0)
    kg = _heads(k_pages, table, kv_head0, kv_heads)
    vg = _heads(v_pages, table, kv_head0, kv_heads)
    hkv = kg.shape[2]
    rep = h // hkv
    pad = span - pps * page
    kg = torch.nn.functional.pad(kg, (0, 0, 0, 0, 0, pad))
    vg = torch.nn.functional.pad(vg, (0, 0, 0, 0, 0, pad))
    qg = q.float().reshape(b, hkv, rep, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, kg) * (1.0 / math.sqrt(d))
    pos = torch.arange(span, device=q.device)
    valid = (pos[None, :] < lengths[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, -math.inf).reshape(b, hkv, rep, n_split, run)
    valid = valid.reshape(b, 1, 1, n_split, run)
    m = s.amax(dim=-1)                                        # [B,G,R,n]
    m_safe = torch.where(m == -math.inf, 0.0, m)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bgrns,bnsgd->bgrnd", p,
                       vg.reshape(b, n_split, run, hkv, d))
    top = m.amax(dim=-1, keepdim=True)
    top = torch.where(top == -math.inf, 0.0, top)
    w = torch.where(m == -math.inf, 0.0, torch.exp(m - top))
    den = (w * l).sum(dim=-1).clamp_min(1e-20)
    y = (w[..., None] * acc).sum(dim=-2) / den[..., None]
    return y.reshape(b, h, d).to(q.dtype)
