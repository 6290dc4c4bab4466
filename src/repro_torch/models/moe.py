"""Mixture-of-Experts FFN: top-k routing with GShard capacity assignment,
tokens moved to and from the experts by the MoE dispatch and combine
kernels.

The twin of ``repro.models.moe``.  The reference moves tokens with two
einsums against [G, S, E, C] one-hot tensors (``gsec,gsd->egcd`` and
``egcd,gsec->gsd``); here the same routing (float32 softmax, top-k,
renormalised weights, choice-priority capacity assignment with float32
cumsums, the same tokens dropped) gives each (token, choice) one flat
slot ``(e * G + g) * cap + pos`` or -1, and
:mod:`repro_torch.kernels.moe_dispatch` scatters tokens into those slots
and gathers the expert outputs back: the kernels the JAX package wrote in
Pallas but its model never called.  The expert FFN is a batched matrix
product over ``[E, G * cap, D]``.  The combine weights are the top-k
weights rounded to bfloat16 first, as the reference's combine tensor is,
and the expert inputs are rounded to bfloat16 (in a float32 model too), as
the reference's dispatch einsum rounds them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.moe_dispatch import ops as moe_ops
from . import layers
from .types import ModelConfig


def moe_capacity(cfg: ModelConfig, group_size: int) -> int:
    cap = int(group_size * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-cap // 4) * 4)  # round up to a multiple of 4


class MoE(nn.Module):
    """Router (float32), stacked expert weights and the optional shared
    expert, in the reference's leaves and layout."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = layers._param((d, e), torch.float32, device)
        self.wi_gate = layers._param((e, d, f), dt, device)
        self.wi_up = layers._param((e, d, f), dt, device)
        self.wo = layers._param((e, f, d), dt, device)
        self.shared = (layers.MLP(cfg, device=device)
                       if cfg.n_shared_experts else None)

    def reset_parameters(self, generator) -> None:
        """The router and experts; the shared expert is an :class:`MLP`
        that :meth:`LM.reset_parameters` reaches on its own."""
        for w in (self.router, self.wi_gate, self.wi_up, self.wo):
            layers.dense_init_(w, generator)


class _Dispatch(torch.autograd.Function):
    """out[slot[t, k]] = x[t] (the kernel on CUDA, its plain version on
    the CPU); backward: dx[t] = sum_k dout[slot[t, k]] over the kept
    choices, summed in float32."""

    @staticmethod
    def forward(ctx, x, slot, n_slots):
        ctx.save_for_backward(slot)
        return moe_ops.dispatch(x, slot, n_slots=n_slots)

    @staticmethod
    def backward(ctx, dout):
        (slot,) = ctx.saved_tensors
        kept = (slot >= 0)[..., None]
        rows = dout[slot.clamp(min=0).long()].float()            # [T,K,D]
        dx = torch.where(kept, rows, 0.0).sum(dim=1)
        return dx.to(dout.dtype), None, None


class _Combine(torch.autograd.Function):
    """y[t] = sum_k w[t,k] ye[slot[t,k]] (the kernel on CUDA, its plain
    version on the CPU); backward: dye[slot[t,k]] = w[t,k] dy[t] (kept
    slots are distinct, so the scatter adds nothing twice) and dw[t,k] =
    dy[t] . ye[slot[t,k]], both in float32, zero for dropped choices."""

    @staticmethod
    def forward(ctx, ye, slot, w):
        ctx.save_for_backward(ye, slot, w)
        return moe_ops.combine(ye, slot, w)

    @staticmethod
    def backward(ctx, dy):
        ye, slot, w = ctx.saved_tensors
        kept = slot >= 0
        safe = slot.clamp(min=0).long()
        dyf = dy.float()
        dw = torch.where(kept, (dyf[:, None, :] * ye[safe].float()).sum(-1),
                         0.0)
        contrib = w.float()[..., None] * dyf[:, None, :]          # [T,K,D]
        dye = torch.zeros(ye.shape, dtype=torch.float32, device=ye.device)
        dye[safe[kept]] = contrib[kept]
        return dye.to(ye.dtype), None, dw.to(w.dtype)


def _route(p: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """Routing of grouped tokens xt [G, S, D]: (probs [G,S,E] float32,
    top_i [G,S,K], top_w [G,S,K] float32, slot [G*S, K] int32)."""
    g, gs, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, gs)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)          # [G,S,E]
    top_w, top_i = torch.topk(probs, k, dim=-1)                   # [G,S,K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # capacity assignment, choice-priority order (GShard)
    counts = torch.zeros((g, e), dtype=torch.float32, device=xt.device)
    group = torch.arange(g, device=xt.device)[:, None]
    slots = []
    for i in range(k):
        mask_i = F.one_hot(top_i[..., i], e).float()              # [G,S,E]
        pos_i = torch.cumsum(mask_i, dim=1) - mask_i + counts[:, None, :]
        keep = (pos_i < cap).float() * mask_i
        counts = counts + keep.sum(dim=1)
        choice = top_i[..., i:i + 1]
        pos = pos_i.gather(-1, choice)[..., 0].long()             # [G,S]
        kept = keep.gather(-1, choice)[..., 0] > 0
        slots.append(torch.where(kept, (top_i[..., i] * g + group) * cap
                                 + pos, -1))
    slot = torch.stack(slots, dim=-1).reshape(g * gs, k).to(torch.int32)
    return probs, top_i, top_w, slot


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., D] (any leading shape); returns (y, aux load-balance loss
    float32)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    gs = min(cfg.moe_group_size, n_tok)
    assert n_tok % gs == 0, (n_tok, gs)
    g = n_tok // gs
    e = cfg.n_experts
    cap = moe_capacity(cfg, gs)
    xt = tokens.reshape(g, gs, d)
    probs, top_i, top_w, slot = _route(p, xt, cfg)

    xe = _Dispatch.apply(tokens.to(torch.bfloat16), slot, e * g * cap)
    xe = xe.reshape(e, g * cap, d).to(p.wi_gate.dtype)
    h = F.silu(torch.bmm(xe, p.wi_gate)) * torch.bmm(xe, p.wi_up)
    ye = torch.bmm(h, p.wo).reshape(e * g * cap, d)
    y = _Combine.apply(ye, slot,
                       top_w.reshape(n_tok, -1).to(torch.bfloat16))
    if p.shared is not None:
        y = y + layers.apply_mlp(p.shared, tokens).to(y.dtype)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    route_frac = F.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    prob_frac = probs.mean(dim=(0, 1))
    aux = e * torch.sum(route_frac * prob_frac)
    return y.reshape(orig_shape).to(x.dtype), aux


def routing_trace(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Expert indices chosen per token [T, K] int32: the irregular index
    stream of this family."""
    logits = x.reshape(-1, x.shape[-1]).float() @ p.router
    return torch.topk(torch.softmax(logits, -1), cfg.top_k,
                      dim=-1).indices.to(torch.int32)
