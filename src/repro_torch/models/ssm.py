"""Mamba-2 (SSD, state-space duality) mixer [arXiv:2405.21060].

The twin of ``repro.models.ssm``: the chunked matmul form for train /
prefill, whose scan runs on the hand-written SSD kernel on the card
(:mod:`repro_torch.kernels.ssd_scan`; the reference model computes it with
its own einsums and never calls its Pallas kernel), and the O(1)
single-token recurrence for decode.  One state group: B and C are shared
across heads.  The projections are separate weights, as in the reference.

Shapes: d_inner = expand * d_model, H = d_inner / ssm_d_head heads of size
P, state size N = ssm_state, depthwise causal conv of width W over x, B
and C.  Decode caches are updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan import ref as ssd_ref
from . import layers
from .types import ModelConfig


class SSM(nn.Module):
    """The reference's SSM leaves: projections and convs in ``cfg.dtype``;
    A_log, D, dt_bias and the gated norm's scale in float32."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_conv)
        f32 = torch.float32
        self.in_z = layers._param((d, di), dt, device)
        self.in_x = layers._param((d, di), dt, device)
        self.in_b = layers._param((d, n), dt, device)
        self.in_c = layers._param((d, n), dt, device)
        self.in_dt = layers._param((d, h), dt, device)
        self.conv_x = layers._param((w, di), dt, device)
        self.conv_bx = layers._param((di,), dt, device)
        self.conv_b = layers._param((w, n), dt, device)
        self.conv_bb = layers._param((n,), dt, device)
        self.conv_c = layers._param((w, n), dt, device)
        self.conv_bc = layers._param((n,), dt, device)
        self.A_log = layers._param((h,), f32, device)
        self.D = layers._param((h,), f32, device)
        self.dt_bias = layers._param((h,), f32, device)
        self.norm_scale = layers._param((di,), f32, device)
        self.out_proj = layers._param((di, d), dt, device)

    def reset_parameters(self, generator) -> None:
        for w in (self.in_z, self.in_x, self.in_b, self.in_c, self.in_dt,
                  self.out_proj):
            layers.dense_init_(w, generator)
        for w in (self.conv_x, self.conv_b, self.conv_c):
            layers.dense_init_(w, generator, scale=0.1)
        for b in (self.conv_bx, self.conv_bb, self.conv_bc, self.A_log,
                  self.dt_bias):
            b.zero_()
        self.D.fill_(1.0)
        self.norm_scale.fill_(1.0)


def _causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv over seq.  x: [B,S,C]; w: [W,C]; optional ring
    ``state`` [B,W-1,C] (decode).  Returns (out in x's dtype, new ring
    state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    full = torch.cat([pad, x], dim=1)                    # [B, S+W-1, C]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + full[:, i:i + x.shape[1], :].float() * w[i].float()
    out = F.silu(out + b.float())
    new_state = full[:, -(width - 1):, :] if width > 1 else pad
    return out.to(x.dtype), new_state


def _gated_norm(y, z, scale, eps):
    yf = y.float() * F.silu(z.float())
    ms = yf.square().mean(dim=-1, keepdim=True)
    return yf * torch.rsqrt(ms + eps) * scale


class _SSDChunked(torch.autograd.Function):
    """y of the SSD scan, float32.  Forward: the kernel on CUDA tensors
    (64-row sub-chunks), the plain chunked form on CPU ones; backward: the
    plain chunked form at ``chunk``, recomputed under autograd (its masked
    decay keeps the gradient finite where the reference's is NaN)."""

    @staticmethod
    def forward(ctx, xh, dt, a_log, b_mat, c_mat, d_skip, chunk):
        ctx.save_for_backward(xh, dt, a_log, b_mat, c_mat, d_skip)
        ctx.chunk = chunk
        return ssd_ops.ssd(xh, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk,
                           out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = ssd_ref.ssd_chunked_ref(*inputs, chunk=ctx.chunk)
        wants = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wants, dy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def ssd_chunked(xh, dt, a_log, b_mat, c_mat, d_skip, *, chunk: int):
    """SSD scan in chunked matmul form.

    xh [B,S,H,P] head inputs; dt [B,S,H] softplus'd step sizes; a_log [H]
    (A = -exp(a_log)); b_mat, c_mat [B,S,N]; d_skip [H].  Returns y
    [B,S,H,P] float32.  The reference also returns the final state, which
    none of its model paths uses; decode has its own recurrence."""
    s = xh.shape[1]
    assert s % min(chunk, s) == 0, (s, chunk)
    return _SSDChunked.apply(xh, dt, a_log, b_mat, c_mat, d_skip, chunk)


def _project(p: SSM, x: torch.Tensor):
    return x @ p.in_z, x @ p.in_x, x @ p.in_b, x @ p.in_c, x @ p.in_dt


def apply_ssm(p: SSM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer (train / prefill)."""
    h = cfg.ssm_heads
    z, xin, b_mat, c_mat, dt_raw = _project(p, x)
    xin, _ = _causal_conv(xin, p.conv_x, p.conv_bx)
    b_mat, _ = _causal_conv(b_mat, p.conv_b, p.conv_bb)
    c_mat, _ = _causal_conv(c_mat, p.conv_c, p.conv_bc)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    xh = xin.reshape(*xin.shape[:-1], h, cfg.ssm_d_head)
    y = ssd_chunked(xh, dt, p.A_log, b_mat, c_mat, p.D, chunk=cfg.ssm_chunk)
    y = y.reshape(*x.shape[:-1], cfg.d_inner)
    y = _gated_norm(y, z, p.norm_scale, cfg.norm_eps)
    return y.to(x.dtype) @ p.out_proj


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Decode state: SSD state + per-stream conv ring buffers (O(1) in S)."""
    di, n = cfg.d_inner, cfg.ssm_state
    dt = getattr(torch, cfg.dtype)
    w = cfg.ssm_conv - 1
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_d_head, n),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, w, di), dtype=dt, device=device),
        "conv_b": torch.zeros((batch, w, n), dtype=dt, device=device),
        "conv_c": torch.zeros((batch, w, n), dtype=dt, device=device),
    }


def decode_ssm(p: SSM, x: torch.Tensor, cache: dict,
               cfg: ModelConfig) -> torch.Tensor:
    """Single-token recurrence.  x: [B,1,D] -> y [B,1,D]; ``cache`` (one
    layer's :func:`init_ssm_cache` dict) is updated in place."""
    di, h = cfg.d_inner, cfg.ssm_heads
    z, xin, b_mat, c_mat, dt_raw = _project(p, x)
    xin, conv_x = _causal_conv(xin, p.conv_x, p.conv_bx,
                               state=cache["conv_x"])
    b_mat, conv_b = _causal_conv(b_mat, p.conv_b, p.conv_bb,
                                 state=cache["conv_b"])
    c_mat, conv_c = _causal_conv(c_mat, p.conv_c, p.conv_bc,
                                 state=cache["conv_c"])
    dt = F.softplus(dt_raw.float() + p.dt_bias)[:, 0, :]          # [B,H]
    xh = xin.reshape(xin.shape[0], h, cfg.ssm_d_head).float()
    decay = torch.exp(dt * (-torch.exp(p.A_log)))                 # [B,H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, b_mat[:, 0, :].float())
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_mat[:, 0, :].float())
    y = y + p.D[None, :, None] * xh
    y = _gated_norm(y.reshape(x.shape[0], 1, di), z, p.norm_scale,
                    cfg.norm_eps)
    for name, new in (("state", state), ("conv_x", conv_x),
                      ("conv_b", conv_b), ("conv_c", conv_c)):
        cache[name].copy_(new)
    return y.to(x.dtype) @ p.out_proj
