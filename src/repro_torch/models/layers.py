"""Layer library: norms, RoPE, the SwiGLU and GELU MLPs and GQA attention
(over a cache with per-row positions for serving, or one shared position
for the legacy decode; reference and blocked attention over the whole
sequence for training and prefill; encoder-decoder cross attention).

Parameters live in small ``nn.Module``s (:class:`Norm`, :class:`Attention`,
:class:`MLP`) holding the same leaves, shapes and dtypes as the JAX
package's parameter dicts: weights are ``[d_in, d_out]`` and applied as
``x @ w``, norm scales are float32.  The ``apply_*`` functions are plain
functions over those modules and tensors, with the reference's signatures,
so each can be held against its twin in ``repro.models.layers``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import sharding
from ..kernels.flash_attention import ops as flash_ops
from ..sharding.rules import even
from .types import ModelConfig

DEFAULT_SCALE = 0.02


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float = DEFAULT_SCALE) -> None:
    """N(0, scale) drawn in the tensor's own dtype, on its own device."""
    w.normal_(0.0, scale, generator=generator)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMS or layer norm parameters (float32, as in the reference)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.scale = _param((d,), torch.float32, device)
        self.bias = (_param((d,), torch.float32, device)
                     if cfg.norm_kind == "layer" else None)

    def reset_parameters(self, generator=None) -> None:
        del generator
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()


def apply_norm(p: Norm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_kind == "layer":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p.scale + p.bias
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim / 2] float32, computed on ``device``: a host tensor copied
    to the card would stall the host until the stream drains."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, D] with D even; positions: broadcastable to [..., S]."""
    freqs = sharding.replicated(rope_freqs(x.shape[-1], theta, x.device), x)
    positions = sharding.replicated(positions, x)
    ang = positions[..., None].float() * freqs                # [..., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (SwiGLU: ``wi_gate``, ``wi_up``, ``wo``) or, with
    ``gated=False``, GELU (``wi``, ``wo``) MLP parameters."""

    def __init__(self, cfg: ModelConfig, gated: bool = True, *, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        d, f = cfg.d_model, cfg.d_ff
        if gated:
            self.wi_gate = _param((d, f), dt, device)
            self.wi_up = _param((d, f), dt, device)
        else:
            self.wi = _param((d, f), dt, device)
        self.wo = _param((f, d), dt, device)

    def reset_parameters(self, generator) -> None:
        for w in self.parameters():
            dense_init_(w, generator)


def apply_mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """The branch is picked by the leaves ``p`` holds, as in the reference;
    its ``jax.nn.gelu`` is the tanh approximation.  On a mesh the sequence
    is gathered first (:func:`repro_torch.sharding.whole_sequence`) and
    the output is ``wo``'s partial sums, which the caller scatters onto
    the residual stream's layout."""
    x = sharding.whole_sequence(x)
    if hasattr(p, "wi_gate"):
        h = F.silu(x @ p.wi_gate) * (x @ p.wi_up)
    else:
        h = F.gelu(x @ p.wi, approximate="tanh")
    return h @ p.wo


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_q: int
    n_kv: int
    d_head: int

    @property
    def rep(self) -> int:
        return self.n_q // self.n_kv


def attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(cfg.n_heads, cfg.n_kv_heads or cfg.n_heads, cfg.head_dim)


class Attention(nn.Module):
    """Q/K/V/O projections (and the optional QKV biases)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        dims = attn_dims(cfg)
        d, dq, dkv = cfg.d_model, dims.n_q * dims.d_head, dims.n_kv * dims.d_head
        self.wq = _param((d, dq), dt, device)
        self.wk = _param((d, dkv), dt, device)
        self.wv = _param((d, dkv), dt, device)
        self.wo = _param((dq, d), dt, device)
        bias = cfg.qkv_bias
        self.bq = _param((dq,), dt, device) if bias else None
        self.bk = _param((dkv,), dt, device) if bias else None
        self.bv = _param((dkv,), dt, device) if bias else None

    def reset_parameters(self, generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()


def _project_qkv(p: Attention, xq: torch.Tensor, xkv: torch.Tensor,
                 dims: AttnDims):
    """[B,S,D] inputs -> q [B,Hq,S,Dh], k/v [B,Hkv,S,Dh] (on a mesh, each
    input's sequence gathered first)."""
    same = xkv is xq
    xq = sharding.whole_sequence(xq)
    xkv = xq if same else sharding.whole_sequence(xkv)
    q = xq @ p.wq
    k = xkv @ p.wk
    v = xkv @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (_split_heads(q, dims.n_q, dims.d_head),
            _split_heads(k, dims.n_kv, dims.d_head),
            _split_heads(v, dims.n_kv, dims.d_head))


def _split_heads(t: torch.Tensor, heads: int, d_head: int) -> torch.Tensor:
    """[B,S,H*Dh] -> [B,H,S,Dh] (on a mesh, the feature dim gathered first
    where its shards would split a head)."""
    t = sharding.divisible(t, t.ndim - 1, heads)
    return t.reshape(*t.shape[:2], heads, d_head).transpose(1, 2)


def _merge_heads(p: Attention, y: torch.Tensor) -> torch.Tensor:
    """[B,H,S,Dh] -> [B,S,D] through ``wo``, as one 2-D product: a
    [B, 1, H*Dh] operand would fold into ``mm`` or run ``bmm`` on an
    expanded weight by the stride of its size-1 dim, which a view (a
    DTensor's local one too) leaves as it comes, and the two differ in
    their last bits."""
    b, h, s, d = y.shape
    return (_flat_heads(y) @ p.wo).reshape(b, s, -1)


def _flat_heads(y: torch.Tensor) -> torch.Tensor:
    """[B,H,S,Dh] -> [B*S, H*Dh].  On a mesh whose ``model`` axis does not
    divide the heads (12 over 16), the heads are gathered for the view
    and the flat feature dim sharded over ``model`` after it, an autograd
    step of its own: the product's gradient then reaches the view
    gathered, where DTensor would refuse to view a feature dim sharded 16
    ways as 12 heads."""
    b, h, s, d = y.shape
    if isinstance(y, DTensor) and "model" in (y.device_mesh.mesh_dim_names
                                              or ()):
        mesh = y.device_mesh
        m = mesh.mesh_dim_names.index("model")
        if h % mesh.size(m) and (h * d) % mesh.size(m) == 0 \
                and y.placements[m] != Shard(0):
            y = y.redistribute(mesh, [Replicate() if i == m else p
                                      for i, p in enumerate(y.placements)])
            flat = y.transpose(1, 2).reshape(b * s, h * d)
            return flat.redistribute(mesh, [Shard(1) if i == m else p for
                                            i, p in enumerate(flat.placements)])
    return y.transpose(1, 2).reshape(b * s, h * d)


def cache_attention(q, k_cache, v_cache, k_positions, q_positions,
                    window: int | None = None):
    """Attention of ``q`` [B,Hq,C,D] against a cache [B,Hkv,S,D] with
    *per-row* positions: ``k_positions`` [1|B, S] holds each cache slot's
    absolute position (-1 = empty), ``q_positions`` [1|B, C] each query's.
    A cache slot takes part iff its position is in [0, q_position] (and
    inside the sliding window when given), so rows at different decode
    depths share one batched product.

    Scores and softmax run in float32 (the reference's
    ``preferred_element_type``); the probabilities are cast to the cache's
    dtype for the product with V.  K and V are made contiguous first, so
    two callers that hold the same values in different layouts (the paged
    gather and the dense cache) run the same arithmetic bit for bit."""
    if isinstance(q, DTensor):
        return _attention_region(
            lambda q, k, v, kp, qp: cache_attention(q, k, v, kp, qp,
                                                    window=window),
            q, k_cache, v_cache, k_positions, q_positions)
    b, hq, c, d = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    qg = q.reshape(b, hkv, rep * c, d)
    s = torch.matmul(qg.float(), k_cache.float().transpose(-1, -2))
    s = s.reshape(b, hkv, rep, c, s_len) / math.sqrt(d)
    kp = k_positions[:, None, None, None, :]
    qp = q_positions[:, None, None, :, None]
    valid = (kp >= 0) & (kp <= qp)
    if window is not None:
        valid &= qp - kp < window
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    y = torch.matmul(p.reshape(b, hkv, rep * c, s_len), v_cache)
    return y.reshape(b, hq, c, d)


def _attention_region(fn, q, k, v, *rows):
    """``fn`` on each rank's shards of q [B, Hq, ...], k, v [B, Hkv, ...]
    and of ``rows`` ([B | 1, ...] positions, plain or DTensors): the batch
    split where q's or the cache's is (q is small: a decode step's
    projection may leave it a partial sum over the data axes, and
    following it would gather the whole cache), the heads too where each
    shard holds whole KV heads (gathered otherwise), everything else
    replicated (a cache's sequence shards gathered).  The GQA views of
    attention flatten (B, H), which DTensor (torch 2.11) refuses on a
    sharded head dim; in the region ``fn`` sees plain tensors."""
    mesh = q.device_mesh
    b, hkv = q.shape[0], k.shape[1]
    heads = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                      if p == Shard(1))
    kept = (k.placements if isinstance(k, DTensor)
            else (Replicate(),) * mesh.ndim)
    pl = [Shard(0) if Shard(0) in (p, c) else
          p if p == Shard(1) and hkv % heads == 0 else Replicate()
          for p, c in zip(q.placements, kept)]
    if b % math.prod(mesh.size(i) for i, p in enumerate(pl)
                     if p == Shard(0)):
        pl = [Replicate() if p == Shard(0) else p for p in pl]
    k, v, *rows = (sharding.replicated(t, q) for t in (k, v, *rows))
    row_pls = [[p if p == Shard(0) and r.shape[0] == b else Replicate()
                for p in pl] for r in rows]
    return local_map(fn, out_placements=pl,
                     in_placements=(pl, pl, pl, *row_pls), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, *rows)


def decode_attention(q, k_cache, v_cache, k_positions, *, pos: int,
                     window: int | None = None) -> torch.Tensor:
    """Single-token decode: q [B,Hq,1,D] against a (possibly ring) cache
    [B,Hkv,S,D] at one shared position ``pos`` (the legacy serve path; the
    continuous-batching engine calls :func:`cache_attention` with per-slot
    positions directly)."""
    return cache_attention(q, k_cache, v_cache, k_positions[None, :],
                           torch.full((1, 1), pos, device=q.device),
                           window=window)


def reference_attention(q, k, v, *, causal: bool, window: int | None = None):
    """Oracle softmax attention.  q: [B,Hq,Sq,D]; k,v: [B,Hkv,Sk,D].
    Scores and softmax in float32, probabilities cast to v's dtype for the
    product with V; a fully masked row gives 0."""
    if isinstance(q, DTensor):
        return _attention_region(
            lambda q, k, v: reference_attention(q, k, v, causal=causal,
                                                window=window), q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep, sq, d)
    scores = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    scores = scores / math.sqrt(d)
    mask = _chunk_mask(torch.arange(sq, device=q.device),
                       torch.arange(sk, device=q.device), causal, window)
    scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)  # fully masked rows
    y = torch.matmul(probs.to(v.dtype), v[:, :, None])
    return y.reshape(b, hq, sq, d)


def _chunk_mask(q_pos, k_pos, causal: bool, window):
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def _chunk_masked_out(q_lo: int, q_hi: int, k_lo: int, k_hi: int,
                      causal: bool, window) -> bool:
    """Whether no query in positions [q_lo, q_hi] sees a key in [k_lo,
    k_hi]: such a chunk pair adds exact zeros, so it is skipped."""
    return (causal and q_hi < k_lo) or (window is not None
                                        and q_lo - k_hi >= window)


def _blocked_bwd(q, k, v, y, lse, dy, causal, window, q_chunk, k_chunk,
                 q_offset):
    """FlashAttention-style backward, the port of ``_blocked_vjp_bwd``:
    scores are recomputed per (q_chunk x k_chunk) pair from the forward's
    lse, so the [Sq, Sk] probabilities are never stored; every product and
    accumulation is float32.  Chunk pairs that the masks empty are skipped
    (the reference adds their zeros)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nq, nk = sq // q_chunk, sk // k_chunk
    scale = 1.0 / math.sqrt(d)
    dy = dy.float()
    delta = (dy * y.float()).sum(dim=-1)
    kf, vf = k.float(), v.float()
    dq = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    dk = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        q_i = q[:, :, qs].float()
        dy_i = dy[:, :, qs]
        lse_i = lse[:, :, qs, None]
        delta_i = delta[:, :, qs, None]
        q_lo = q_offset + qi * q_chunk
        q_pos = q_lo + torch.arange(q_chunk, device=q.device)
        dq_i = torch.zeros(b, h, q_chunk, d, dtype=torch.float32,
                           device=q.device)
        for kj in range(nk):
            k_lo = kj * k_chunk
            if _chunk_masked_out(q_lo, q_lo + q_chunk - 1, k_lo,
                                 k_lo + k_chunk - 1, causal, window):
                continue
            ks = slice(k_lo, k_lo + k_chunk)
            k_j, v_j = kf[:, :, ks], vf[:, :, ks]
            k_pos = k_lo + torch.arange(k_chunk, device=q.device)
            s = torch.matmul(q_i, k_j.transpose(-1, -2)) * scale
            mask = _chunk_mask(q_pos, k_pos, causal, window)
            p = torch.where(mask, torch.exp(s - lse_i), 0.0)
            dp = torch.matmul(dy_i, v_j.transpose(-1, -2))
            ds = p * (dp - delta_i) * scale
            dq_i += torch.matmul(ds, k_j)
            dk[:, :, ks] += torch.matmul(ds.transpose(-1, -2), q_i)
            dv[:, :, ks] += torch.matmul(p.transpose(-1, -2), dy_i)
        dq[:, :, qs] = dq_i
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockedAttention(torch.autograd.Function):
    """Forward: the flash kernel on CUDA tensors, its plain version on CPU
    ones (``kernels.flash_attention.ops``), returning y and saving the row
    lse; backward: :func:`_blocked_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, k_chunk, q_offset):
        y, lse = flash_ops.attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, y, lse)
        ctx.args = (causal, window, q_chunk, k_chunk, q_offset)
        return y

    @staticmethod
    def backward(ctx, dy):
        q, k, v, y, lse = ctx.saved_tensors
        dq, dk, dv = _blocked_bwd(q, k, v, y, lse, dy, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def blocked_attention(q, k, v, *, causal: bool, window: int | None = None,
                      q_chunk: int = 512, k_chunk: int = 1024,
                      q_offset: int = 0, triangular: bool = False):
    """FlashAttention-style attention with a flash backward (scores
    recomputed, never stored).  The forward runs the hand-written kernel on
    the card; chunk sizes shape only the backward.

    GQA KV is expanded to the query heads *outside* the autograd Function,
    so autograd sums the head repeat.  ``triangular`` is the reference's
    TPU schedule of the same causal function (its k_chunk follows
    q_chunk); here it maps to the same Function, whose kernel skips fully
    masked tiles in every causal call."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    assert sq % q_chunk == 0 and sk % k_chunk == 0, (sq, q_chunk, sk, k_chunk)
    if hkv != hq:
        k = sharding.constrain(k, "attn_kv_rep")   # replicated over model
        v = sharding.constrain(v, "attn_kv_rep")
        k = k.repeat_interleave(hq // hkv, dim=1)  # shard-local expansion
        v = v.repeat_interleave(hq // hkv, dim=1)
    q = sharding.constrain(q, "attn_heads")
    k = sharding.constrain(k, "attn_heads")
    v = sharding.constrain(v, "attn_heads")
    if triangular:
        k_chunk = q_chunk
    args = (causal, window, q_chunk, k_chunk, q_offset)
    if not isinstance(q, DTensor):
        return _BlockedAttention.apply(q, k, v, *args)
    pad = _head_padding(q)
    if pad:
        q, k, v = (torch.cat([t, torch.zeros_like(t[:, :1]).expand(
            -1, pad, -1, -1)], dim=1) for t in (q, k, v))
    y = _local_heads(q, lambda q, k, v: _BlockedAttention.apply(
        q, k, v, *args), q, k, v)
    return y[:, :hq] if pad else y


def _head_padding(q: DTensor) -> int:
    """Zero heads to add so that ``model`` divides them, where it divides
    neither the heads nor the batch left over the data axes (qwen2's 12
    heads over 16 at a prefill's 32 rows): each rank then computes its
    share of the heads, one real or padded head, where it would otherwise
    compute every head, as GSPMD pads an uneven shard.  0 elsewhere."""
    mesh = q.device_mesh
    if "model" not in (mesh.mesh_dim_names or ()):
        return 0
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    b, h = q.shape[:2]
    batch = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                      if p == Shard(0)) * m
    return 0 if h % m == 0 or b % batch == 0 else (-h) % m


def _local_heads(like: DTensor, fn, *tensors):
    """``fn`` on each rank's shards of ``tensors`` [B, H, ...] (DTensors),
    all laid out as ``like``: batch and heads may be sharded, nothing else
    (a sequence shard would need a distributed softmax).  The kernel
    wrappers take plain tensors only; ``local_map`` hands them the local
    shards, forward and backward, and wraps the result back.  A dim that
    its axes do not divide evenly (12 heads over 16) is gathered, and the
    batch is then split over ``model`` where it divides (the heads where
    they were padded to divide, :func:`_head_padding`)."""
    mesh = like.device_mesh
    pl = even(like.placements, like.shape, mesh.shape)
    if "model" in (mesh.mesh_dim_names or ()):
        # heads that "model" does not divide: split the batch over it
        # instead where the batch divides, so no rank repeats another's
        m = mesh.mesh_dim_names.index("model")
        ways = math.prod(mesh.size(i) for i, p in enumerate(pl)
                         if p == Shard(0)) * mesh.size(m)
        if pl[m] == Replicate() and like.shape[0] % ways == 0:
            pl[m] = Shard(0)
        elif pl[m] == Replicate() and like.shape[1] % mesh.size(m) == 0:
            pl[m] = Shard(1)                 # heads padded to divide
    for p in pl:
        if isinstance(p, Partial) or (isinstance(p, Shard) and p.dim > 1):
            raise ValueError(f"attention over {pl}: only the batch and head "
                             f"dims may be sharded")
    return local_map(fn, out_placements=pl, in_placements=(pl,) * len(tensors),
                     device_mesh=like.device_mesh,
                     redistribute_inputs=True)(*tensors)


def apply_attention(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, causal: bool = True,
                    impl: str = "auto", q_chunk: int = 512,
                    k_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    dims = attn_dims(cfg)
    q, k, v = _project_qkv(p, x, x, dims)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions[None, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[None, None, :], cfg.rope_theta)
    window = cfg.window if cfg.attention_kind == "swa" else None
    s = x.shape[1]
    if impl == "auto":
        impl = "blocked" if s > max(q_chunk, k_chunk) else "reference"
    if impl in ("blocked", "triangular"):
        y = blocked_attention(q, k, v, causal=causal, window=window,
                              q_chunk=min(q_chunk, s), k_chunk=min(k_chunk, s),
                              triangular=(impl == "triangular"))
    else:
        y = reference_attention(q, k, v, causal=causal, window=window)
    return _merge_heads(p, y)


def apply_cross_attention(p: Attention, x: torch.Tensor, ctx: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross attention (no positions / mask): queries from
    ``x`` [B,T,D], keys and values from ``ctx`` [B,S,D]."""
    dims = attn_dims(cfg)
    q, k, v = _project_qkv(p, x, ctx, dims)
    y = reference_attention(q, k, v, causal=False)
    return _merge_heads(p, y)
