"""The causal LM covering the dense / MoE / hybrid / SSM archs:
parameters, the training / prefill forward, the chunked cross-entropy
loss and the legacy lockstep decode.

The reference stacks each layer-pattern position's parameters
``[n_groups, ...]`` and scans over groups; here the stack is an
``nn.ModuleList`` of one :class:`Block` per layer, where layer
``group * period + pattern_index`` holds the reference's slice
``groups[pattern_index][group]`` (see :mod:`repro_torch.checkpoint.convert`).
The decode cache keeps one entry per layer in the same order and is
updated in place.  The continuous-batching serve steps live in
:mod:`.paged_lm`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers, moe, ssm
from .types import LayerSpec, ModelConfig


class Block(nn.Module):
    """One decoder layer: mixer norm + attention or SSM mixer, then (unless
    the pattern has none) FFN norm + MLP or MoE.  Absent parts are None."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *, device=None):
        super().__init__()
        self.mixer_norm = layers.Norm(cfg, device=device)
        attn = spec.mixer == "attn"
        self.attn = layers.Attention(cfg, device=device) if attn else None
        self.ssm = None if attn else ssm.SSM(cfg, device=device)
        self.ffn_norm = self.mlp = self.moe = None
        if spec.ffn != "none":
            self.ffn_norm = layers.Norm(cfg, device=device)
            if spec.ffn == "moe":
                self.moe = moe.MoE(cfg, device=device)
            else:
                self.mlp = layers.MLP(cfg, device=device)


class LM(nn.Module):
    """Embedding, the layer stack, the final norm and the (optional) head."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: an encoder-decoder model is "
                             f"built by models.encdec.EncDec")
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        pattern = cfg.pattern()
        self.embed = layers._param((cfg.vocab_size, cfg.d_model), dt, device)
        self.final_norm = layers.Norm(cfg, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        layers._param((cfg.d_model, cfg.vocab_size), dt,
                                      device))
        self.blocks = nn.ModuleList(
            Block(cfg, pattern[i % cfg.period], device=device)
            for i in range(cfg.n_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights N(0, 0.02) in ``cfg.dtype``, norm scales ones, biases
        zeros: the reference's layout and law, not its numbers."""
        layers.dense_init_(self.embed, generator)
        if self.lm_head is not None:
            layers.dense_init_(self.lm_head, generator)
        for m in self.modules():
            if isinstance(m, (layers.Norm, layers.Attention, layers.MLP,
                              moe.MoE, ssm.SSM)):
                m.reset_parameters(generator)


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device=None) -> LM:
    """A randomly initialised LM, drawn on ``device`` (the generator's
    device) so a full-width model never passes through host memory."""
    model = LM(cfg, device=device)
    with torch.no_grad():
        model.reset_parameters(generator)
    return model


def _lm_head(params: LM, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(block: Block, x: torch.Tensor, cfg: ModelConfig
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN half on the residual stream: (new x, the MoE aux
    loss, 0 without an MoE FFN).  An MoE routes every row of x."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if block.ffn_norm is None:
        return x, aux
    h = layers.apply_norm(block.ffn_norm, x, cfg)
    if block.moe is not None:
        h, aux = moe.apply_moe(block.moe, h, cfg)
    else:
        h = layers.apply_mlp(block.mlp, h)
    return x + h, aux


def _apply_block(block: Block, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, attn_impl: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer: (new x, its MoE aux loss)."""
    h = layers.apply_norm(block.mixer_norm, x, cfg)
    if block.attn is not None:
        h = layers.apply_attention(block.attn, h, positions, cfg,
                                   impl=attn_impl)
    else:
        h = ssm.apply_ssm(block.ssm, h, cfg)
    return _ffn(block, x + h, cfg)


def _remat(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward instead
    of kept (the reference's ``jax.checkpoint``) when autograd records."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def forward(params: LM, batch: dict, cfg: ModelConfig,
            attn_impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states [B,S,D], the MoE aux loss summed over
    layers: 0 without MoE FFNs).  Each layer runs under activation
    checkpointing, so only its input is kept for the backward, which runs
    the layer's forward again (the reference's per-layer remat)."""
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        x = batch["embeds"].to(params.embed.dtype)
    else:
        x = F.embedding(batch["tokens"], params.embed)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params.blocks:
        x, a = _remat(_apply_block, block, x, positions, cfg, attn_impl)
        aux = aux + a
    x = layers.apply_norm(params.final_norm, x, cfg)
    return x, aux


def _ce_chunk(xc: torch.Tensor, w_head: torch.Tensor,
              lc: torch.Tensor) -> torch.Tensor:
    logits = (xc @ w_head).float()
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 256
                          ) -> torch.Tensor:
    """Mean token CE over sequence chunks: each chunk's [B, c, V] logits
    live only while its term is computed, in the forward and again in the
    backward, and are never kept."""
    b, s, _ = x.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + _remat(_ce_chunk, x[:, i:i + c], w_head,
                               labels[:, i:i + c])
    return total / (b * s)


def lm_loss(params: LM, batch: dict, cfg: ModelConfig,
            attn_impl: str = "auto", aux_weight: float = 0.01
            ) -> torch.Tensor:
    x, aux = forward(params, batch, cfg, attn_impl)
    ce = chunked_cross_entropy(x, _lm_head(params, cfg), batch["labels"])
    return ce + aux_weight * aux


def prefill_logits(params: LM, batch: dict, cfg: ModelConfig,
                   attn_impl: str = "auto") -> torch.Tensor:
    """Prefill: full-sequence forward, logits of the last position only."""
    x, _ = forward(params, batch, cfg, attn_impl)
    return (x[:, -1, :] @ _lm_head(params, cfg)).float()


# ---------------------------------------------------------------------------
# decode (the legacy lockstep loop: every sequence at one shared position)
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.attention_kind == "swa":
        return min(cfg.window, seq_len)
    return seq_len


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> dict:
    """Decode state on ``device``: ``pos`` (a host int, the position every
    sequence is at) and one dict a layer, in the LM's layer order.

    ``cfg.kv_quant`` stores K/V as int8 with a per-(token, head) float32
    scale, dequantized in the attention read."""
    dt = torch.int8 if cfg.kv_quant else getattr(torch, cfg.dtype)
    dims = layers.attn_dims(cfg)
    s_c = cache_len(cfg, seq_len)
    pattern = cfg.pattern()
    caches = []
    for i in range(cfg.n_layers):
        if pattern[i % cfg.period].mixer == "attn":
            shape = (batch, dims.n_kv, s_c, dims.d_head)
            c = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
            if cfg.kv_quant:
                for name in ("k_scale", "v_scale"):
                    c[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                          device=device)
            caches.append(c)
        else:
            caches.append(ssm.init_ssm_cache(cfg, batch, device))
    return {"pos": 0, "layers": caches}


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B,H,1,D] -> (int8 values, per-(B,H,1) float32 scale)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _decode_attn(p: layers.Attention, x: torch.Tensor, c: dict, pos: int,
                 cfg: ModelConfig) -> torch.Tensor:
    """One token at position ``pos`` for every sequence: x [B,1,D] ->
    [B,1,D]; writes its K/V into the layer cache ``c`` in place."""
    kc, vc = c["k"], c["v"]
    dims = layers.attn_dims(cfg)
    q, k, v = layers._project_qkv(p, x, x, dims)
    if cfg.rope_theta > 0:
        pp = torch.full((1, 1, 1), pos, device=x.device)
        q = layers.apply_rope(q, pp, cfg.rope_theta)
        k = layers.apply_rope(k, pp, cfg.rope_theta)
    s_c = kc.shape[2]
    if cfg.attention_kind == "swa" and s_c == cfg.window:
        slot = pos % s_c
        slot_ids = torch.arange(s_c, device=x.device)
        k_positions = pos - (pos - slot_ids) % s_c   # < 0 for unwritten slots
        window = cfg.window
    else:
        slot = min(pos, s_c - 1)     # the reference's dynamic_update_slice
        k_positions = torch.arange(s_c, device=x.device)   # clamps too
        window = cfg.window if cfg.attention_kind == "swa" else None
    if cfg.kv_quant:
        for name, t in (("k", k), ("v", v)):
            qv, scale = _quantize_kv(t)
            c[name][:, :, slot] = qv[:, :, 0]
            c[f"{name}_scale"][:, :, slot] = scale[:, :, 0]
        k_read = kc.to(torch.bfloat16) \
            * c["k_scale"][..., None].to(torch.bfloat16)
        v_read = vc.to(torch.bfloat16) \
            * c["v_scale"][..., None].to(torch.bfloat16)
    else:
        kc[:, :, slot] = k[:, :, 0]
        vc[:, :, slot] = v[:, :, 0]
        k_read, v_read = kc, vc
    y = layers.decode_attention(q, k_read, v_read, k_positions, pos=pos,
                                window=window)
    return layers._merge_heads(p, y.to(x.dtype))


@torch.no_grad()
def decode_step(params: LM, tokens: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One lockstep serving step: tokens [B,1] -> (logits [B,V] float32,
    cache), the cache updated in place and its position advanced."""
    pos = cache["pos"]
    x = F.embedding(tokens.long(), params.embed)          # [B,1,D]
    for block, c in zip(params.blocks, cache["layers"]):
        h = layers.apply_norm(block.mixer_norm, x, cfg)
        if block.attn is not None:
            h = _decode_attn(block.attn, h, c, pos, cfg)
        else:
            h = ssm.decode_ssm(block.ssm, h, c, cfg)
        x, _ = _ffn(block, x + h, cfg)
    x = layers.apply_norm(params.final_norm, x, cfg)
    logits = (x[:, 0, :] @ _lm_head(params, cfg)).float()
    cache["pos"] = pos + 1
    return logits, cache
