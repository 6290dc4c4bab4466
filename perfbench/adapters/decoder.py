"""The program's adapter for the decoder family
(:mod:`perfbench.reference.decoder`): ``repro_torch``'s dense or MoE LM
on the benchmark's weights.

It builds the program's model configuration from a configuration file's
``perfbench.arch`` block and places the weights that
:mod:`perfbench.weights` drew into the program's LM (views of the drawn
buffers, no copy but for the float32 leaves).  A configuration names it
as its ``perfbench.adapter``; :func:`perfbench.program.start` builds the
engine on what it returns.  A family that extends this one imports it and
passes its own ``place`` for each layer.
"""
from __future__ import annotations

import torch
from torch import nn

from perfbench import weights


def model_config(arch: dict, name: str):
    """The program's ModelConfig for a configuration's arch block."""
    from repro_torch.models.types import ModelConfig
    moe = arch["n_experts"] > 0
    return ModelConfig(
        name=name, family="moe" if moe else "dense",
        n_layers=arch["n_layers"], d_model=arch["d_model"],
        n_heads=arch["n_heads"], n_kv_heads=arch["n_kv_heads"],
        d_head=arch["d_head"], d_ff=arch["d_ff"],
        vocab_size=arch["vocab_size"], qkv_bias=arch["qkv_bias"],
        rope_theta=float(arch["rope_theta"]),
        n_experts=arch["n_experts"], top_k=arch["top_k"],
        capacity_factor=float(arch.get("capacity_factor", 1.25)),
        tie_embeddings=arch["tie_embeddings"], norm_kind=arch["norm"],
        norm_eps=float(arch["norm_eps"]), dtype="bfloat16")


def put(module: nn.Module, name: str, tensor: torch.Tensor) -> None:
    setattr(module, name, nn.Parameter(tensor, requires_grad=False))


def _norm(norm: nn.Module, scale: torch.Tensor) -> None:
    put(norm, "scale", scale)
    if norm.bias is not None:
        put(norm, "bias", torch.zeros_like(scale))


def place(block: nn.Module, w: dict) -> None:
    """One layer's drawn leaves into the program's block."""
    _norm(block.mixer_norm, w["mixer_norm"])
    _norm(block.ffn_norm, w["ffn_norm"])
    for leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        if leaf in w:
            put(block.attn, leaf, w[leaf])
    ffn = block.moe if block.moe is not None else block.mlp
    if block.moe is not None:
        put(ffn, "router", w["router"].float())
    put(ffn, "wi_gate", w["wi_gate"])
    put(ffn, "wi_up", w["wi_up"])
    put(ffn, "wo", w["wo_ffn"])


def build_lm(cfg, arch: dict, seed: int, device, ref, place=place):
    """The program's LM holding this run's weights, drawn part by part as
    the reference module ``ref`` lays them out."""
    from repro_torch.models.lm import LM
    lm = LM(cfg, device="meta")
    for part in ref.parts(arch):
        w = weights.draw(ref, arch, seed, part, device)
        if part == "embed":
            put(lm, "embed", w["embed"])
        elif part == "head":
            put(lm, "lm_head", w["head"])
        elif part == "final_norm":
            _norm(lm.final_norm, w["scale"])
        else:
            place(lm.blocks[int(part[len("layer"):])], w)
    left = [n for n, p in lm.named_parameters() if p.is_meta]
    if left:
        raise RuntimeError(f"leaves the benchmark did not draw: {left}")
    return lm
