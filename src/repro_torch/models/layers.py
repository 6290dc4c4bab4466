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

from ..kernels.flash_attention import ops as flash_ops
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
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [D/2]
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
    its ``jax.nn.gelu`` is the tanh approximation."""
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
    """[B,S,D] inputs -> q [B,Hq,S,Dh], k/v [B,Hkv,S,Dh]."""
    q = xq @ p.wq
    k = xkv @ p.wk
    v = xkv @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    b = xq.shape[0]
    q = q.reshape(b, xq.shape[1], dims.n_q, dims.d_head).transpose(1, 2)
    k = k.reshape(b, xkv.shape[1], dims.n_kv, dims.d_head).transpose(1, 2)
    v = v.reshape(b, xkv.shape[1], dims.n_kv, dims.d_head).transpose(1, 2)
    return q, k, v


def _merge_heads(p: Attention, y: torch.Tensor) -> torch.Tensor:
    b, h, s, d = y.shape
    return y.transpose(1, 2).reshape(b, s, h * d) @ p.wo


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
    b, hq, c, d = q.shape
    hkv, s_len = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    qg = q.reshape(b, hkv, rep * c, d)
    s = torch.matmul(qg.float(), k_cache.float().transpose(-1, -2))
    s = s.reshape(b, hkv, rep, c, s_len) / math.sqrt(d)
    kp = k_positions[:, None, None, None, :]       # [1|B,1,1,1,S]
    qp = q_positions[:, None, None, :, None]       # [1|B,1,1,C,1]
    valid = (kp >= 0) & (kp <= qp)
    if window is not None:
        valid &= qp - kp < window
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    y = torch.matmul(p.reshape(b, hkv, rep * c, s_len), v_cache)
    return y.reshape(b, hq, c, d)


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
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if triangular:
        k_chunk = q_chunk
    return _BlockedAttention.apply(q, k, v, causal, window, q_chunk, k_chunk,
                                   q_offset)


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
