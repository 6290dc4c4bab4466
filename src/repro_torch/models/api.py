"""Model API: parameter init, the training loss, prefill, the legacy
lockstep decode and the serve dispatchers.

The twin of ``repro.models.api`` for the LM family (dense, MoE, hybrid and
SSM archs); the encoder-decoder family waits for a later slice of the port.
Entry points run on the CUDA card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

from . import lm, paged_lm
from .types import ModelConfig


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet")
    return lm.init_lm(cfg, generator, device)


def batch_to(batch: dict, device=None) -> dict:
    """Every array of a batch (numpy or tensor) as a tensor on ``device``
    (the card when None)."""
    device = resolve_device(device)
    return {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
                else v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# training / prefill
# ---------------------------------------------------------------------------

def _no_encdec(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet")


def train_loss(params, batch: dict, cfg: ModelConfig, *,
               device=None) -> torch.Tensor:
    """Scalar training loss of ``batch`` (moved to ``device``, the card
    when None)."""
    _no_encdec(cfg)
    return lm.lm_loss(params, batch_to(batch, device), cfg,
                      attn_impl=cfg.attn_impl)


def prefill(params, batch: dict, cfg: ModelConfig, *,
            device=None) -> torch.Tensor:
    """Last-position logits [B, V] float32 of ``batch``."""
    _no_encdec(cfg)
    return lm.prefill_logits(params, batch_to(batch, device), cfg,
                             attn_impl=cfg.attn_impl)


# ---------------------------------------------------------------------------
# legacy lockstep decode (one shared position for the whole batch)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device=None):
    """Zeroed decode state for ``batch`` sequences of up to ``seq_len``
    tokens, on ``device`` (the card when None)."""
    _no_encdec(cfg)
    return lm.init_decode_cache(cfg, batch, seq_len, resolve_device(device))


def decode(params, tokens, cache, cfg: ModelConfig):
    """One lockstep step: tokens [B, 1] (a tensor or host array) ->
    (logits [B, V] float32, cache), the cache updated in place on its own
    device."""
    _no_encdec(cfg)
    device = next(iter(cache["layers"][0].values())).device
    return lm.decode_step(params, torch.as_tensor(tokens, device=device),
                          cache, cfg)


# ---------------------------------------------------------------------------
# continuous-batching serve path (slot batches over a paged / dense cache)
# ---------------------------------------------------------------------------

def serve_supported(cfg: ModelConfig) -> tuple[bool, str]:
    """Whether the continuous-batching engine covers this arch."""
    return paged_lm.serve_supported(cfg)


def init_serve_cache(cfg: ModelConfig, *, slots: int, max_len: int,
                     backend: str = "paged", page_size: int = 16,
                     n_pages: int | None = None, device=None):
    return paged_lm.init_serve_cache(cfg, slots=slots, max_len=max_len,
                                     backend=backend, page_size=page_size,
                                     n_pages=n_pages, device=device)


def serve_decode(params, tokens, active, temps, key_data, cache,
                 cfg: ModelConfig, **kw):
    """Slot-batched decode step; see :func:`paged_lm.serve_decode_step`."""
    return paged_lm.serve_decode_step(params, tokens, active, temps, key_data,
                                      cache, cfg, **kw)


def serve_prefill(params, tokens, n_valid, slot, temp, key_data, cache,
                  cfg: ModelConfig, **kw):
    """Chunked prefill for one slot; see :func:`paged_lm.serve_prefill_chunk`."""
    return paged_lm.serve_prefill_chunk(params, tokens, n_valid, slot, temp,
                                        key_data, cache, cfg, **kw)
