"""The system under test: ``repro_torch``'s ServeEngine on the benchmark's
weights.

This is the only module of the harness that imports the program.  It
builds the program's model configuration from a configuration file's
``perfbench.arch`` block, places the weights that :mod:`perfbench.weights`
drew into the program's LM (views of the drawn buffers, no copy but for
the float32 leaves) and starts the engine with the traffic file's
geometry, reading decode attention through the paged-attention kernel.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import weights


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


def _put(module: nn.Module, name: str, tensor: torch.Tensor) -> None:
    setattr(module, name, nn.Parameter(tensor, requires_grad=False))


def _norm(norm: nn.Module, scale: torch.Tensor) -> None:
    _put(norm, "scale", scale)
    if norm.bias is not None:
        _put(norm, "bias", torch.zeros_like(scale))


def build_lm(cfg, arch: dict, seed: int, device):
    """The program's LM holding this run's weights."""
    from repro_torch.models.lm import LM
    lm = LM(cfg, device="meta")
    for part in weights.parts(arch):
        w = weights.draw(arch, seed, part, device)
        if part == "embed":
            _put(lm, "embed", w["embed"])
        elif part == "head":
            _put(lm, "lm_head", w["head"])
        elif part == "final_norm":
            _norm(lm.final_norm, w["scale"])
        else:
            block = lm.blocks[int(part[len("layer"):])]
            _norm(block.mixer_norm, w["mixer_norm"])
            _norm(block.ffn_norm, w["ffn_norm"])
            for leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
                if leaf in w:
                    _put(block.attn, leaf, w[leaf])
            ffn = block.moe if block.moe is not None else block.mlp
            if block.moe is not None:
                _put(ffn, "router", w["router"].float())
            _put(ffn, "wi_gate", w["wi_gate"])
            _put(ffn, "wi_up", w["wi_up"])
            _put(ffn, "wo", w["wo_ffn"])
    left = [n for n, p in lm.named_parameters() if p.is_meta]
    if left:
        raise RuntimeError(f"leaves the benchmark did not draw: {left}")
    return lm


@dataclasses.dataclass
class System:
    cfg: object
    lm: object
    engine: object


def engine(cfg, lm, engine_kw: dict, device, clock):
    """A fresh ServeEngine over ``lm`` with a traffic file's geometry."""
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, lm, slots=engine_kw["slots"],
                       max_len=engine_kw["max_len"],
                       page_size=engine_kw["page_size"],
                       n_pages=engine_kw.get("n_pages"),
                       prefill_chunk=engine_kw["prefill_chunk"],
                       attn_read="kernel", clock=clock, device=device)


def start(arch: dict, name: str, engine_kw: dict, seed: int, device,
          clock) -> System:
    """The engine on this run's weights, on ``device``."""
    cfg = model_config(arch, name)
    lm = build_lm(cfg, arch, seed, device)
    return System(cfg, lm, engine(cfg, lm, engine_kw, device, clock))


def request_states():
    """The program's request states (FINISHED, and the terminal set)."""
    from repro_torch.serve.scheduler import TERMINAL, RequestState
    return RequestState, TERMINAL


def backpressure():
    from repro_torch.serve.engine import Backpressure
    return Backpressure
