"""Serve-step assembly for the continuous-batching engine.

The twin of ``build_serve_engine_steps`` in ``repro.launch.steps``.  The
reference jits its step pair and donates the cache argument so the page
pools update in place; PyTorch runs eagerly, and the steps here write the
cache tensors in place themselves (see :mod:`repro_torch.models.paged_lm`),
returning the same dict.  Shapes are still fixed at build time (slot count,
padded cache length, prefill chunk), whatever the batch composition.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models import api
from repro_torch.models.types import ModelConfig


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
