"""Slot-batched serving model steps over a paged (or dense) KV cache.

The model half of the continuous-batching serving engine
(:mod:`repro_torch.serve`), the twin of ``repro.models.paged_lm``.  Every
slot of the batch is an independent sequence at its own depth; slots join
and leave between steps, and the KV cache behind them is either

* ``paged`` — per layer a physical page pool (``k_pages``/``v_pages``:
  ``[n_pages, page, Hkv, Dh]``) indirected through a per-slot
  ``page_table`` ``[B, pages_per_seq]`` plus per-slot ``lengths`` ``[B]``,
  exactly the operand layout of :mod:`repro_torch.kernels.paged_attention`,
  so the decode read can run through that kernel (``attn_read="kernel"``);
  or
* ``dense`` — per layer, per-slot contiguous KV ``[B, Hkv, S+1, Dh]``
  (slot ``S`` is a write-diversion scratch row), the oracle the paged path
  is tested bit-identical against.

Both backends run the *same* projection / RoPE / attention / FFN code with
the same shapes; only where K/V bytes live differs.  Stale bytes in reused
pages sit strictly behind the position mask of
:func:`repro_torch.models.layers.cache_attention`, where softmax weights are
exactly 0.0, which is what makes paged-vs-dense outputs bitwise equal.

The reference's steps are pure functions whose jit donates the cache; here
the steps update the cache tensors **in place** (page-pool scatters,
``lengths``) and return the same dict.  Masked writes keep the shapes
fixed: inactive decode slots and prefill padding divert their write to the
reserved null page 0 (paged; rewriting the value already there) or to the
scratch row S (dense).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import sharding
from ..sharding.rules import local_box
from . import layers
from .lm import LM, _ffn, _lm_head
from .types import ModelConfig

NULL_PAGE = 0  # physical page 0 is reserved: idle page-table entries point here


# ---------------------------------------------------------------------------
# support / geometry
# ---------------------------------------------------------------------------

def serve_supported(cfg: ModelConfig) -> tuple[bool, str]:
    """Whether the port's continuous-batching serve path covers this arch."""
    if any(spec.mixer != "attn" for spec in cfg.pattern()):
        return False, "paged serving covers attention mixers only (SSM/hybrid state is slot-resident, not paged)"
    if cfg.family == "encdec":
        return False, "encoder-decoder serving needs a cross-attention cache"
    if cfg.attention_kind != "full":
        return False, "sliding-window ring caches do not page"
    if cfg.kv_quant:
        return False, "int8 KV paging (scale pages) not implemented"
    return True, ""


def serve_geometry(max_len: int, page_size: int) -> tuple[int, int]:
    """(pages_per_seq, padded_cache_len) for a max sequence length."""
    pages_per_seq = -(-max_len // page_size)
    return pages_per_seq, pages_per_seq * page_size


def init_serve_cache(cfg: ModelConfig, *, slots: int, max_len: int,
                     backend: str = "paged", page_size: int = 16,
                     n_pages: int | None = None, device=None) -> dict:
    """Zeroed serve cache on ``device``: ``lengths`` [slots] int32 and, per
    layer, the paged pools (plus one ``page_table`` [slots, pages] int32)
    or the dense rows.  ``paged`` pools default to full provisioning (every
    slot can hold ``max_len``) plus the null page; a smaller ``n_pages``
    creates page pressure."""
    ok, why = serve_supported(cfg)
    if not ok:
        raise ValueError(f"{cfg.name}: {why}")
    dims = layers.attn_dims(cfg)
    dt = getattr(torch, cfg.dtype)
    pages_per_seq, s_pad = serve_geometry(max_len, page_size)
    cache: dict = {"lengths": torch.zeros((slots,), dtype=torch.int32,
                                          device=device)}
    if backend == "paged":
        n_pages = n_pages if n_pages is not None else 1 + slots * pages_per_seq
        if n_pages < 2:
            raise ValueError("need at least the null page plus one real page")
        cache["page_table"] = torch.zeros((slots, pages_per_seq),
                                          dtype=torch.int32, device=device)
        shape = (n_pages, page_size, dims.n_kv, dims.d_head)
        cache["layers"] = [
            {"k_pages": torch.zeros(shape, dtype=dt, device=device),
             "v_pages": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]
    elif backend == "dense":
        shape = (slots, dims.n_kv, s_pad + 1, dims.d_head)
        cache["layers"] = [
            {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]
    else:
        raise ValueError(f"unknown serve-cache backend {backend!r}")
    return cache


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _gumbel(key_data, vocab: int, device) -> torch.Tensor:
    """Gumbel noise [vocab] from a generator seeded by one uint32[2] key.

    Both key words are mixed into every bit of the seed: the CPU generator
    reads only the seed's low 32 bits, CUDA's Philox all 64."""
    words = [int(w) for w in key_data]
    seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    u = torch.rand(vocab, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def _sample(logits: torch.Tensor, temps, key_data) -> torch.Tensor:
    """logits [..., V] float32; temps [...] (0 = greedy) and key_data
    uint32 [..., 2] as host arrays.

    Temperature rows draw by Gumbel-max from noise keyed only by their own
    ``key_data`` (the engine derives it from (request seed, token index)),
    so a request's sampled continuation is reproducible across preemption
    and re-batching; temperature-0 rows take the argmax.  The stream is the
    port's own: JAX's threefry draws cannot be reproduced."""
    shape = logits.shape[:-1]
    flat = logits.reshape(-1, logits.shape[-1])
    temps = np.asarray(temps, np.float32).reshape(-1)
    key_data = np.asarray(key_data, np.uint32).reshape(-1, 2)
    out = flat.argmax(dim=-1).to(torch.int32)
    rows = np.flatnonzero(temps > 0.0)
    if rows.size:
        noise = torch.stack([_gumbel(key_data[i], flat.shape[-1], flat.device)
                             for i in rows])
        t = torch.as_tensor(temps[rows], device=flat.device)[:, None]
        idx = torch.as_tensor(rows, device=flat.device)
        out[idx] = (flat[idx] / t + noise).argmax(dim=-1).to(torch.int32)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# per-layer attention with serve-cache read/write
# ---------------------------------------------------------------------------

def _write_paged(pool, pid, off, vals, mask) -> None:
    """Masked in-place scatter of per-token rows into a physical page pool.

    pool [N, page, Hkv, Dh]; pid/off [T]; vals [T, Hkv, Dh]; mask [T].
    Masked-out rows are diverted to the null page by the caller and write
    back the value already there (gathered before the write), so colliding
    diverted writes all carry identical data and the scatter stays
    deterministic on any device.  On a mesh the pool is replicated and
    each rank writes the same rows into its own copy (DTensor has no
    sharding rule for ``index_put_`` in every torch the port runs on)."""
    pool = sharding.local(pool)
    pid, off, vals, mask = (sharding.full(t) for t in (pid, off, vals, mask))
    cur = pool[pid, off]
    pool.index_put_((pid, off), torch.where(mask[:, None, None], vals, cur))


def _attn_decode(p, x, c, cache, active, cfg: ModelConfig,
                 attn_read: str) -> torch.Tensor:
    """One decode token per slot: x [B,1,D] -> y [B,1,D]; writes this
    layer's cache ``c`` in place.  ``cache`` provides the shared
    ``lengths`` / ``page_table``."""
    dims = layers.attn_dims(cfg)
    lengths = cache["lengths"]
    b = x.shape[0]
    q, k, v = layers._project_qkv(p, x, x, dims)
    if cfg.rope_theta > 0:
        pp = lengths[:, None, None]                      # [B,1,1]
        q = layers.apply_rope(q, pp, cfg.rope_theta)
        k = layers.apply_rope(k, pp, cfg.rope_theta)
    k_tok = k[:, :, 0, :]                                # [B,Hkv,Dh]
    v_tok = v[:, :, 0, :]
    b_ids = sharding.replicated(torch.arange(b, device=x.device), lengths)
    lengths_l = lengths.long()
    if "k_pages" in c:
        kp, vp = c["k_pages"], c["v_pages"]
        page = kp.shape[1]
        table = cache["page_table"]
        lp = (lengths_l // page).clamp(0, table.shape[1] - 1)
        pid = torch.where(active, table[b_ids, lp].long(), NULL_PAGE)
        off = torch.where(active, lengths_l % page, 0)
        _write_paged(kp, pid, off, k_tok, active)
        _write_paged(vp, pid, off, v_tok, active)
        if attn_read == "kernel":
            # the paged-attention kernel reads GQA natively (kv head =
            # q head // rep, the reference's jnp.repeat order); lengths + 1
            # counts the token just written
            y = _paged_read(q[:, :, 0, :].contiguous(), kp, vp, table,
                            lengths + 1)[:, :, None, :]
            return layers._merge_heads(p, y)
        tl = table.long()
        k_read = kp[tl].reshape(b, -1, dims.n_kv, dims.d_head).transpose(1, 2)
        v_read = vp[tl].reshape(b, -1, dims.n_kv, dims.d_head).transpose(1, 2)
    else:
        kc, vc = c["k"], c["v"]                          # [B,Hkv,S+1,Dh]
        s_pad = kc.shape[2] - 1
        s_idx = torch.where(active, lengths_l.clamp(0, s_pad - 1), s_pad)
        kc[b_ids, :, s_idx, :] = k_tok
        vc[b_ids, :, s_idx, :] = v_tok
        k_read, v_read = kc[:, :, :s_pad, :], vc[:, :, :s_pad, :]
    s_len = k_read.shape[2]
    y = layers.cache_attention(
        q, k_read, v_read, torch.arange(s_len, device=x.device)[None, :],
        lengths_l[:, None])
    return layers._merge_heads(p, y)


def _paged_read(q, kp, vp, table, lengths):
    """The paged-attention kernel (its plain version on CPU tensors).  On
    DTensors (a mesh) it runs in a ``local_map`` region: the pools, table
    and lengths replicated, q's heads sharded as they come (over
    ``model``) and the rest of q replicated; each rank reads its own query
    heads (:func:`shard_read`)."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    if not isinstance(q, DTensor):
        return paged_ops.paged_attention(q, kp, vp, table, lengths)
    mesh = q.device_mesh
    rep = [Replicate()] * mesh.ndim
    q_pl = [p if p == Shard(1) else Replicate() for p in q.placements]
    lo, hi = local_box(q.shape, mesh, q_pl)[1]
    read = shard_read(q.shape[1], kp.shape[2], lo, hi)
    return local_map(read, out_placements=q_pl,
                     in_placements=(q_pl,) + (rep,) * 4, device_mesh=mesh,
                     redistribute_inputs=True)(q, kp, vp, table, lengths)


def shard_read(h: int, hkv: int, lo: int, hi: int):
    """The paged read of query heads [lo, hi) of ``h`` (one rank's shard)
    on a pool of ``hkv`` KV heads: ``read(q, kp, vp, table, lengths)`` with
    q [B, hi - lo, D].  It reads, from the whole pool in place, the KV
    heads those query heads use (q head // rep): several KV heads for a
    shard of whole groups; for a shard of a part of one group (shards
    sharing a KV head), that KV head for the whole group, the other
    shards' heads zero, of which it keeps its own, so that every head is
    computed as in the unsharded call."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    group = h // hkv
    if hi > lo and lo % group == 0 and (hi - lo) % group == 0:
        kv0, kv_heads, lead = lo // group, (hi - lo) // group, None
    elif hi > lo and lo // group == (hi - 1) // group:
        kv0, kv_heads, lead = lo // group, 1, lo % group
    else:
        raise ValueError(f"paged read: query heads [{lo}, {hi}) of {h} "
                         f"split a group of {group} a KV head unevenly")

    def read(q, kp, vp, table, lengths):
        if lead is not None:                 # the whole group, then ours
            whole = q.new_zeros(q.shape[0], group, q.shape[2])
            whole[:, lead:lead + q.shape[1]] = q
            q, n = whole, q.shape[1]
        y = paged_ops.paged_attention(q, kp, vp, table, lengths,
                                      kv_head0=kv0, kv_heads=kv_heads)
        return y if lead is None else y[:, lead:lead + n].contiguous()

    return read


def _attn_prefill(p, x, c, cache, slot: int, positions, write_mask,
                  cfg: ModelConfig) -> torch.Tensor:
    """Prefill chunk for one slot: x [1,C,D] -> y [1,C,D]; writes this
    layer's cache ``c`` in place.

    Writes the chunk's K/V into the slot's cache region, then attends the
    chunk queries over the slot's full cache (earlier chunks included), so
    chunked prefill is exact — not an approximation of whole-prompt
    prefill."""
    dims = layers.attn_dims(cfg)
    chunk = x.shape[1]
    q, k, v = layers._project_qkv(p, x, x, dims)
    if cfg.rope_theta > 0:
        pp = positions[None, None, :]                    # [1,1,C]
        q = layers.apply_rope(q, pp, cfg.rope_theta)
        k = layers.apply_rope(k, pp, cfg.rope_theta)
    if "k_pages" in c:
        kp, vp = c["k_pages"], c["v_pages"]
        page = kp.shape[1]
        table_row = cache["page_table"][slot].long()     # [P]
        lp = (positions // page).clamp(0, table_row.shape[0] - 1)
        pid = torch.where(write_mask, table_row[lp], NULL_PAGE)
        off = torch.where(write_mask, positions % page, sharding.replicated(
            torch.arange(chunk, device=x.device) % page, positions))
        _write_paged(kp, pid, off, k[0].transpose(0, 1), write_mask)
        _write_paged(vp, pid, off, v[0].transpose(0, 1), write_mask)
        k_read = kp[table_row].reshape(1, -1, dims.n_kv,
                                       dims.d_head).transpose(1, 2)
        v_read = vp[table_row].reshape(1, -1, dims.n_kv,
                                       dims.d_head).transpose(1, 2)
    else:
        kc, vc = c["k"], c["v"]                          # [B,Hkv,S+1,Dh]
        s_pad = kc.shape[2] - 1
        pos_w = torch.where(write_mask, positions.clamp(0, s_pad - 1), s_pad)
        kc[slot][:, pos_w, :] = k[0]
        vc[slot][:, pos_w, :] = v[0]
        k_read = kc[slot][None, :, :s_pad, :]
        v_read = vc[slot][None, :, :s_pad, :]
    s_len = k_read.shape[2]
    y = layers.cache_attention(
        q, k_read, v_read, torch.arange(s_len, device=x.device)[None, :],
        positions[None, :])
    return layers._merge_heads(p, y)


# ---------------------------------------------------------------------------
# engine steps
# ---------------------------------------------------------------------------

def _block(p, x, attn_fn, cfg: ModelConfig) -> torch.Tensor:
    """One layer.  An MoE FFN routes every row of x, as the reference's
    does: in decode the inactive slots too, so capacity counts them."""
    h = layers.apply_norm(p.mixer_norm, x, cfg)
    x, _ = _ffn(p, x + attn_fn(p.attn, h), cfg)
    return x


@torch.no_grad()
def serve_decode_step(params: LM, tokens, active, temps, key_data, cache,
                      cfg: ModelConfig, *, attn_read: str = "gather",
                      sampling: bool = True, return_logits: bool = False):
    """One continuous-batching decode step.

    tokens int [B] (each slot's pending input token) and active bool [B],
    as tensors on the cache's device or host arrays; temps float32 [B] and
    key_data uint32 [B,2] as host arrays.  Active slots append their
    token's K/V at position ``lengths[b]`` and advance; inactive slots are
    write-diverted and their outputs are garbage the host ignores.
    Returns ``(next_tokens [B] int32, logits [B,V] float32 | None, cache)``
    with ``cache`` updated in place.
    """
    lengths = cache["lengths"]
    device = lengths.device
    tokens = sharding.replicated(
        torch.as_tensor(tokens, device=device).long(), lengths)
    active = sharding.replicated(
        torch.as_tensor(active, device=device).bool(), lengths)
    x = sharding.gathered(params.embed)[tokens[:, None]]  # [B,1,D]
    for block, c in zip(params.blocks, cache["layers"]):
        x = _block(block, x, lambda pa, h, c=c: _attn_decode(
            pa, h, c, cache, active, cfg, attn_read), cfg)
    x = layers.apply_norm(params.final_norm, x, cfg)
    logits = (x[:, 0, :] @ _lm_head(params, cfg)).float()
    # the sampler runs on the whole logits on every rank
    logits = sharding.full(sharding.constrain(logits, "decode_logits"))
    if sampling:
        next_tokens = _sample(logits, temps, key_data)
    else:
        next_tokens = logits.argmax(dim=-1).to(torch.int32)
    cache["lengths"] += active.to(torch.int32)
    return next_tokens, (logits if return_logits else None), cache


@torch.no_grad()
def serve_prefill_chunk(params: LM, tokens, n_valid: int, slot: int, temp,
                        key_data, cache, cfg: ModelConfig, *,
                        sampling: bool = True, return_logits: bool = False):
    """Prefill ``n_valid`` prompt tokens (padded to the fixed chunk length
    ``C = len(tokens)``) for one slot.

    Runs a full forward over the chunk, appending K/V for valid positions
    starting at ``lengths[slot]`` — chunk k > 0 attends to the slot's
    earlier chunks through the cache, so any chunking of a prompt yields
    the same cache state.  Returns ``(sampled_token, logits [V] | None,
    cache)`` where the sample is drawn from the last valid position's
    logits (only meaningful on the final chunk of a prompt); ``cache`` is
    updated in place.
    """
    lengths = cache["lengths"]
    device = lengths.device
    tokens = sharding.replicated(
        torch.as_tensor(tokens, device=device).long(), lengths)
    n_valid, slot = int(n_valid), int(slot)
    chunk = tokens.shape[0]
    ar = sharding.replicated(torch.arange(chunk, device=device), lengths)
    positions = lengths[slot].long() + ar
    write_mask = ar < n_valid
    x = sharding.gathered(params.embed)[tokens[None, :]]  # [1,C,D]
    for block, c in zip(params.blocks, cache["layers"]):
        x = _block(block, x, lambda pa, h, c=c: _attn_prefill(
            pa, h, c, cache, slot, positions, write_mask, cfg), cfg)
    x = layers.apply_norm(params.final_norm, x, cfg)
    last = x[0, min(max(n_valid - 1, 0), chunk - 1)]
    logits = sharding.full((last @ _lm_head(params, cfg)).float())
    if sampling:
        token = _sample(logits, temp, key_data)
    else:
        token = logits.argmax().to(torch.int32)
    sharding.local(lengths)[slot] += n_valid
    return token, (logits if return_logits else None), cache
