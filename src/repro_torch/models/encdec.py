"""Encoder-decoder transformer (whisper-small backbone).

The twin of ``repro.models.encdec``.  The conv/audio frontend is a stub:
the encoder consumes precomputed frame embeddings [B, frames, d_model].
Sinusoidal absolute positions, pre-LN blocks, GELU MLPs, LayerNorm.

The reference stacks the encoder's and the decoder's block leaves
``[n_encoder_layers, ...]`` / ``[n_decoder_layers, ...]`` and scans over
them; here each stack is an ``nn.ModuleList`` of one block per layer
(:mod:`repro_torch.checkpoint.convert` maps one onto the other).  Each
block runs under activation checkpointing when autograd records (the
reference's ``jax.checkpoint``).  The decode step keeps the legacy
lockstep convention of :func:`repro_torch.models.lm.decode_step`: ``pos``
is a host int and the cache tensors are updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import sharding
from . import layers, lm
from .types import ModelConfig


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """[S] positions -> [S, d] float32 (sin half, then cos half).  The
    frequencies are float64, rounded to float32 before the product, as the
    reference's numpy constant is under JAX without x64; they are computed
    on the positions' device, never copied from the host."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float64,
                                    device=positions.device)
                     / max(1, half - 1)).float()
    ang = positions[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncBlock(nn.Module):
    """Self-attention (bidirectional) and a GELU MLP, each pre-normed."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.attn_norm = layers.Norm(cfg, device=device)
        self.attn = layers.Attention(cfg, device=device)
        self.mlp_norm = layers.Norm(cfg, device=device)
        self.mlp = layers.MLP(cfg, gated=False, device=device)


class DecBlock(nn.Module):
    """Causal self-attention, cross-attention over the encoder output and
    a GELU MLP, each pre-normed."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.self_norm = layers.Norm(cfg, device=device)
        self.self_attn = layers.Attention(cfg, device=device)
        self.cross_norm = layers.Norm(cfg, device=device)
        self.cross_attn = layers.Attention(cfg, device=device)
        self.mlp_norm = layers.Norm(cfg, device=device)
        self.mlp = layers.MLP(cfg, gated=False, device=device)


class EncDec(nn.Module):
    """Token embedding, the encoder and decoder stacks, their final norms
    and the (untied) head: the reference's leaves, by the same names."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = layers._param((cfg.vocab_size, cfg.d_model), dt, device)
        self.encoder = nn.ModuleList(EncBlock(cfg, device=device)
                                     for _ in range(cfg.n_encoder_layers))
        self.enc_norm = layers.Norm(cfg, device=device)
        self.decoder = nn.ModuleList(DecBlock(cfg, device=device)
                                     for _ in range(cfg.n_decoder_layers))
        self.dec_norm = layers.Norm(cfg, device=device)
        self.lm_head = layers._param((cfg.d_model, cfg.vocab_size), dt,
                                     device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights N(0, 0.02) in ``cfg.dtype``, norm scales ones, biases
        zeros: the reference's layout and law, not its numbers."""
        layers.dense_init_(self.embed, generator)
        layers.dense_init_(self.lm_head, generator)
        for m in self.modules():
            if isinstance(m, (layers.Norm, layers.Attention, layers.MLP)):
                m.reset_parameters(generator)


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> EncDec:
    """A randomly initialised encoder-decoder, drawn on ``device`` (the
    generator's device)."""
    model = EncDec(cfg, device=device)
    with torch.no_grad():
        model.reset_parameters(generator)
    return model


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _enc_block(p: EncBlock, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    h = layers.apply_norm(p.attn_norm, x, cfg)
    x = lm._add(x, layers.apply_attention(p.attn, h, positions, cfg,
                                          causal=False))
    h = layers.apply_norm(p.mlp_norm, x, cfg)
    return lm._add(x, layers.apply_mlp(p.mlp, h))


def encode(params: EncDec, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Frame embeddings [B,S,D] -> encoder output [B,S,D] in ``cfg.dtype``.
    Past 1,024 frames the attention is blocked (the flash kernel on the
    card), which wants S a multiple of 1,024."""
    s = frames.shape[1]
    x = frames.to(getattr(torch, cfg.dtype))
    positions = torch.arange(s, device=x.device)
    x = x + sharding.replicated(sinusoid(positions, cfg.d_model).to(x.dtype),
                                x)
    x = sharding.constrain(x, "activations")
    for block in params.encoder:
        x = lm._remat(_enc_block, block, x, positions, cfg)
    return layers.apply_norm(params.enc_norm, x, cfg)


def _dec_block(p: DecBlock, x: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = layers.apply_norm(p.self_norm, x, cfg)
    x = lm._add(x, layers.apply_attention(p.self_attn, h, positions, cfg,
                                          causal=True))
    h = layers.apply_norm(p.cross_norm, x, cfg)
    x = lm._add(x, layers.apply_cross_attention(p.cross_attn, h, enc_out,
                                                cfg))
    h = layers.apply_norm(p.mlp_norm, x, cfg)
    return lm._add(x, layers.apply_mlp(p.mlp, h))


def _decode_stack(params: EncDec, x: torch.Tensor, enc_out: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    positions = torch.arange(x.shape[1], device=x.device)
    for block in params.decoder:
        x = lm._remat(_dec_block, block, x, enc_out, positions, cfg)
    return layers.apply_norm(params.dec_norm, x, cfg)


def _decoder_out(params: EncDec, batch: dict,
                 cfg: ModelConfig) -> torch.Tensor:
    """Encode ``batch["frames"]`` and run the decoder prompt
    ``batch["dec_tokens"]``: the final decoder hidden states [B,T,D]."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["dec_tokens"]
    x = F.embedding(tokens.long(), sharding.gathered(params.embed))
    positions = torch.arange(tokens.shape[1], device=x.device)
    x = x + sharding.replicated(sinusoid(positions, cfg.d_model).to(x.dtype),
                                x)
    return _decode_stack(params, sharding.constrain(x, "activations"),
                         enc_out, cfg)


def encdec_loss(params: EncDec, batch: dict,
                cfg: ModelConfig) -> torch.Tensor:
    """Mean token cross-entropy of ``batch["labels"]``, the head applied
    in the largest of the reference's chunks that divides T."""
    x = _decoder_out(params, batch, cfg)
    t = x.shape[1]
    chunk = next(c for c in (256, 224, 128, 64, 32, 16, 8, 4, 2, 1)
                 if t % c == 0)
    return lm.chunked_cross_entropy(x, params.lm_head, batch["labels"],
                                    chunk=chunk)


def encdec_prefill(params: EncDec, batch: dict,
                   cfg: ModelConfig) -> torch.Tensor:
    """Encode the frames and run the decoder prompt: logits [B, V] float32
    of the last decoder position."""
    x = sharding.whole_sequence(_decoder_out(params, batch, cfg))
    return (x[:, -1, :] @ params.lm_head).float()


# ---------------------------------------------------------------------------
# decode (the legacy lockstep loop: every sequence at one shared position)
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> dict:
    """Decode state on ``device``: ``pos`` (a host int) and the decoder's
    self-attention K/V [G,B,Hkv,seq_len,Dh] and cross-attention K/V
    [G,B,Hkv,cross_len,Dh], zeros.  A caller with an encoder output puts
    :func:`precompute_cross`'s K/V in ``cross_k`` / ``cross_v``."""
    dt = getattr(torch, cfg.dtype)
    dims = layers.attn_dims(cfg)
    g = cfg.n_decoder_layers

    def zeros(s):
        return torch.zeros((g, batch, dims.n_kv, s, dims.d_head), dtype=dt,
                           device=device)

    return {"pos": 0, "self_k": zeros(seq_len), "self_v": zeros(seq_len),
            "cross_k": zeros(cfg.cross_len), "cross_v": zeros(cfg.cross_len)}


@torch.no_grad()
def precompute_cross(params: EncDec, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K and V of the encoder output
    [B,S,D]: two [G,B,Hkv,S,Dh] tensors (no bias, as in the reference)."""
    dims = layers.attn_dims(cfg)
    b, s = enc_out.shape[:2]
    enc_out = sharding.whole_sequence(enc_out)
    ks, vs = [], []
    for block in params.decoder:
        for w, out in ((block.cross_attn.wk, ks), (block.cross_attn.wv, vs)):
            t = enc_out @ w
            out.append(t.reshape(b, s, dims.n_kv, dims.d_head).transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def encdec_decode_step(params: EncDec, tokens: torch.Tensor, cache: dict,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One lockstep step: tokens [B,1] -> (logits [B,V] float32, cache),
    each layer's self K/V written in place at ``pos`` (the last slot once
    ``pos`` passes the cache, as the reference's update clamps) and the
    position advanced."""
    pos = cache["pos"]
    x = F.embedding(tokens.long(), sharding.gathered(params.embed))
    x = x + sharding.replicated(sinusoid(
        torch.full((1,), pos, device=x.device), cfg.d_model).to(x.dtype)[None],
        x)                                                    # [B,1,D]
    dims = layers.attn_dims(cfg)
    s_c = cache["self_k"].shape[3]
    slot = min(pos, s_c - 1)
    self_positions = torch.arange(s_c, device=x.device)
    s_x = cache["cross_k"].shape[3]
    cross_positions = torch.arange(s_x, device=x.device)
    for i, p in enumerate(params.decoder):
        kc, vc = cache["self_k"][i], cache["self_v"][i]
        h = layers.apply_norm(p.self_norm, x, cfg)
        q, k, v = layers._project_qkv(p.self_attn, h, h, dims)
        sharding.put_(kc, 2, slot, k[:, :, 0])
        sharding.put_(vc, 2, slot, v[:, :, 0])
        y = layers.decode_attention(q, kc, vc, self_positions, pos=pos)
        x = x + layers._merge_heads(p.self_attn, y)
        h = layers.apply_norm(p.cross_norm, x, cfg)
        q = (h @ p.cross_attn.wq).reshape(h.shape[0], 1, dims.n_q,
                                          dims.d_head).transpose(1, 2)
        y = layers.decode_attention(q, cache["cross_k"][i],
                                    cache["cross_v"][i], cross_positions,
                                    pos=s_x)
        x = x + layers._merge_heads(p.cross_attn, y)
        h = layers.apply_norm(p.mlp_norm, x, cfg)
        x = x + layers.apply_mlp(p.mlp, h)
    x = layers.apply_norm(params.dec_norm, x, cfg)
    logits = (x[:, 0, :] @ params.lm_head).float()
    cache["pos"] = pos + 1
    return logits, cache
