"""The train step, the lockstep serve and prefill steps, and the
serve-step assembly.

The twin of ``make_optimizer``, ``train_step``, ``serve_step``,
``prefill_step`` and ``build_serve_engine_steps`` in
``repro.launch.steps``.  The reference jits its steps and donates the
state / cache argument so they update in place; PyTorch runs eagerly, and
the steps here update the optimizer state and the cache tensors in place
themselves (see :mod:`repro_torch.optim.adamw` and
:mod:`repro_torch.models.paged_lm`), returning them.  Serve shapes are
still fixed at build time (slot count, padded cache length, prefill
chunk), whatever the batch composition.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import api
from repro_torch.models.types import ModelConfig
from repro_torch.optim import adamw


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=lr, moment_dtype=cfg.adam_dtype)


def _grads(loss: torch.Tensor, leaves) -> tuple:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not
    use (an embeddings-input model's token table), as ``jax.grad`` gives."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def train_step(state: dict, batch: dict, cfg: ModelConfig,
               opt: adamw.AdamWConfig, transform=None, *, device=None):
    """Loss + grads + AdamW update; returns (state, metrics), the state
    updated in place.  ``batch`` moves to ``device`` (the card when None).

    ``cfg.accum_steps > 1`` runs gradient accumulation: the batch is split
    into microbatches run one after another, their gradients summed in
    float32 (bf16 leaves have bf16 grads, as in the reference)."""
    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    batch = api.batch_to(batch, device)
    accum = max(1, cfg.accum_steps)
    if accum == 1:
        loss = api.train_loss(params, batch, cfg, device=device)
        grads = _grads(loss, leaves)
    else:
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum):
            mb = {k: v[i] for k, v in micro.items()}
            l = api.train_loss(params, mb, cfg, device=device)
            for acc, g in zip(grads, _grads(l, leaves)):
                acc.add_(g.float())
            loss = loss + l.detach()
        grads = [g / accum for g in grads]
        loss = loss / accum
    grads = dict(zip(names, grads))
    state = adamw.apply_updates(state, grads, cfg=opt, transform=transform)
    metrics = {"loss": loss.detach(), "grad_norm": adamw.global_norm(grads)}
    return state, metrics


def serve_step(params, tokens, cache, cfg: ModelConfig):
    """One legacy lockstep decode step: (logits [B, V] float32, cache),
    the cache updated in place on its own device."""
    return api.decode(params, tokens, cache, cfg)


def prefill_step(params, batch: dict, cfg: ModelConfig, *, device=None):
    """Last-position logits [B, V] float32 of ``batch`` (moved to
    ``device``, the card when None)."""
    return api.prefill(params, batch, cfg, device=device)


@dataclasses.dataclass
class ServeSteps:
    """Step pair + cache factory for the continuous-batching engine.

    ``decode(params, tokens, active, temps, key_data, cache)`` and
    ``prefill(params, tokens, n_valid, slot, temp, key_data, cache)`` both
    update ``cache`` in place and return it as their last output.
    """

    decode: Any
    prefill: Any
    init_cache: Any          # () -> zeroed serve cache on the device


def build_serve_engine_steps(cfg: ModelConfig, *, slots: int, max_len: int,
                             backend: str = "paged", page_size: int = 16,
                             n_pages: int | None = None,
                             attn_read: str = "gather",
                             sampling: bool = True,
                             return_logits: bool = False,
                             device=None) -> ServeSteps:
    """Assemble the continuous-batching serve steps (paged or dense cache)
    for a cache on ``device``."""
    if attn_read not in ("gather", "kernel"):
        raise ValueError(f"unknown attn_read {attn_read!r}")
    if attn_read == "kernel" and backend != "paged":
        raise ValueError("attn_read='kernel' reads the paged pools; "
                         "use backend='paged'")

    def make_cache():
        return api.init_serve_cache(cfg, slots=slots, max_len=max_len,
                                    backend=backend, page_size=page_size,
                                    n_pages=n_pages, device=device)

    def decode_fn(params, tokens, active, temps, key_data, cache):
        return api.serve_decode(params, tokens, active, temps, key_data,
                                cache, cfg, attn_read=attn_read,
                                sampling=sampling,
                                return_logits=return_logits)

    def prefill_fn(params, tokens, n_valid, slot, temp, key_data, cache):
        return api.serve_prefill(params, tokens, n_valid, slot, temp,
                                 key_data, cache, cfg, sampling=sampling,
                                 return_logits=return_logits)

    return ServeSteps(decode=decode_fn, prefill=prefill_fn,
                      init_cache=make_cache)
