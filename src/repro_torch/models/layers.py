"""Layer library, serving subset: norms, RoPE, the SwiGLU MLP and GQA
attention over a cache with per-row positions.

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
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (SwiGLU) MLP parameters."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        d, f = cfg.d_model, cfg.d_ff
        self.wi_gate = _param((d, f), dt, device)
        self.wi_up = _param((d, f), dt, device)
        self.wo = _param((f, d), dt, device)

    def reset_parameters(self, generator) -> None:
        for w in (self.wi_gate, self.wi_up, self.wo):
            dense_init_(w, generator)


def apply_mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p.wi_gate) * (x @ p.wi_up)
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


def cache_attention(q, k_cache, v_cache, k_positions, q_positions):
    """Attention of ``q`` [B,Hq,C,D] against a cache [B,Hkv,S,D] with
    *per-row* positions: ``k_positions`` [1|B, S] holds each cache slot's
    absolute position (-1 = empty), ``q_positions`` [1|B, C] each query's.
    A cache slot takes part iff its position is in [0, q_position], so rows
    at different decode depths share one batched product.

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
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    y = torch.matmul(p.reshape(b, hkv, rep * c, s_len), v_cache)
    return y.reshape(b, hq, c, d)
