"""Model API: parameter init, the training loss, prefill, the legacy
lockstep decode, abstract (meta-device) parameters, inputs and caches, and
the serve dispatchers.

The twin of ``repro.models.api`` over the LM family (dense, MoE, hybrid
and SSM archs) and the encoder-decoder family.  Entry points run on the
CUDA card unless ``device="cpu"`` is passed; the abstract functions build
on the ``meta`` device and allocate nothing.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device

from . import encdec, lm, paged_lm
from .types import ModelConfig, ShapeConfig

META = torch.device("meta")


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    if cfg.family == "encdec":
        return encdec.init_encdec(cfg, generator, device)
    return lm.init_lm(cfg, generator, device)


def abstract_params(cfg: ModelConfig) -> torch.nn.Module:
    """The model with every parameter on the meta device: shapes and
    dtypes, no storage and no random draw."""
    if cfg.family == "encdec":
        return encdec.EncDec(cfg, device=META)
    return lm.LM(cfg, device=META)


def is_meta(t) -> bool:
    """Whether ``t`` is a meta tensor, or a DTensor of meta shards: an
    abstract input, which no step moves."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return isinstance(t, torch.Tensor) and t.is_meta


def batch_to(batch: dict, device=None) -> dict:
    """Every array of a batch (numpy or tensor) as a tensor on ``device``
    (the card when None); a meta tensor stays where it is."""
    device = resolve_device(device)
    return {k: v if is_meta(v) else
            (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
             else v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# training / prefill
# ---------------------------------------------------------------------------

def train_loss(params, batch: dict, cfg: ModelConfig, *,
               device=None) -> torch.Tensor:
    """Scalar training loss of ``batch`` (moved to ``device``, the card
    when None)."""
    batch = batch_to(batch, device)
    if cfg.family == "encdec":
        return encdec.encdec_loss(params, batch, cfg)
    return lm.lm_loss(params, batch, cfg, attn_impl=cfg.attn_impl)


def prefill(params, batch: dict, cfg: ModelConfig, *,
            device=None) -> torch.Tensor:
    """Last-position logits [B, V] float32 of ``batch``."""
    batch = batch_to(batch, device)
    if cfg.family == "encdec":
        return encdec.encdec_prefill(params, batch, cfg)
    return lm.prefill_logits(params, batch, cfg, attn_impl=cfg.attn_impl)


# ---------------------------------------------------------------------------
# legacy lockstep decode (one shared position for the whole batch)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *, device=None):
    """Zeroed decode state for ``batch`` sequences of up to ``seq_len``
    tokens, on ``device`` (the card when None)."""
    device = resolve_device(device)
    if cfg.family == "encdec":
        return encdec.init_encdec_cache(cfg, batch, seq_len, device)
    return lm.init_decode_cache(cfg, batch, seq_len, device)


def decode(params, tokens, cache, cfg: ModelConfig):
    """One lockstep step: tokens [B, 1] (a tensor or host array) ->
    (logits [B, V] float32, cache), the cache updated in place on its own
    device."""
    if cfg.family == "encdec":
        device = cache["self_k"].device
        return encdec.encdec_decode_step(
            params, torch.as_tensor(tokens, device=device), cache, cfg)
    device = next(iter(cache["layers"][0].values())).device
    return lm.decode_step(params, torch.as_tensor(tokens, device=device),
                          cache, cfg)


# ---------------------------------------------------------------------------
# abstract inputs and caches (meta tensors: shapes and dtypes only)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input of this cell, by the
    reference's names, shapes and dtypes.

    decode shapes describe ONE serving step: a single new token plus a KV /
    state cache sized for ``shape.seq_len`` (built by
    :func:`abstract_cache`)."""
    b, s = shape.global_batch, shape.seq_len

    def tok(*sh):
        return torch.empty(sh, dtype=torch.int32, device=META)

    def emb(*sh):
        return torch.empty(sh, dtype=torch.bfloat16, device=META)

    if cfg.family == "encdec":
        t = min(cfg.decoder_len, s)
        if shape.kind == "train":
            return {"frames": emb(b, s, cfg.d_model),
                    "dec_tokens": tok(b, t), "labels": tok(b, t)}
        if shape.kind == "prefill":
            return {"frames": emb(b, s, cfg.d_model), "dec_tokens": tok(b, t)}
        return {"tokens": tok(b, 1)}
    if shape.kind == "decode":
        return {"tokens": tok(b, 1)}
    batch = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = emb(b, s, cfg.d_model)
        # decode still runs on generated text tokens via the embed table
    else:
        batch["tokens"] = tok(b, s)
    if shape.kind == "train":
        batch["labels"] = tok(b, s)
    return batch


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """:func:`init_cache` of a decode cell on the meta device."""
    if shape.kind != "decode":
        raise ValueError(f"{shape.name}: a cache belongs to a decode cell, "
                         f"not a {shape.kind} cell")
    return init_cache(cfg, shape.global_batch, shape.seq_len, device=META)


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
