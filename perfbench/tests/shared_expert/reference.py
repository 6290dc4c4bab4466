"""Plain PyTorch reference of a decoder-family MoE with one shared expert
of the routed experts' width beside them (llama4-scout's shape): each
layer's FFN output is the routed experts' combine plus the shared
SwiGLU expert's output for every token.

A test copies this file to ``perfbench/reference/shared.py`` in a
temporary benchmark tree, beside ``adapter.py`` as
``perfbench/adapters/shared.py``, to add an architecture that the
decoder's files do not build, as new files alone.  It extends
:mod:`perfbench.reference.decoder`: the same parts and leaf kinds, three
more leaves a layer, its own layer and counts.
"""
from __future__ import annotations

import torch

from perfbench.reference import decoder
from perfbench.reference.decoder import (  # noqa: F401  (the module's API)
    attention_layers, leaf, moe_layers, parts)


def layout(arch: dict, part: str) -> list:
    out = decoder.layout(arch, part)
    if part.startswith("layer"):
        d, f = arch["d_model"], arch["d_ff"]
        out += [("shared_gate", (d, f), "w"), ("shared_up", (d, f), "w"),
                ("shared_out", (f, d), "w")]
    return out


def block(x: torch.Tensor, w: dict, arch: dict, mode: str,
          stats: dict) -> torch.Tensor:
    x = x + decoder.attention(decoder.norm(x, w["mixer_norm"], arch), w,
                              arch, mode, stats)
    h = decoder.norm(x, w["ffn_norm"], arch)
    s = torch.nn.functional.silu(decoder.matmul(h, w["shared_gate"], mode)) \
        * decoder.matmul(h, w["shared_up"], mode)
    return x + (decoder.ffn(h, w, arch, mode)
                + decoder.matmul(s, w["shared_out"], mode))


def logits(arch: dict, part, seqs: list, rows: list, modes=("f32",),
           device=None) -> dict:
    return decoder.forward(arch, part, seqs, rows, modes, block)


def shared_params(arch: dict) -> int:
    return arch["n_layers"] * 3 * arch["d_model"] * arch["d_ff"]


def active_params(arch: dict) -> int:
    return decoder.active_params(arch) + shared_params(arch)


def step_flops(arch: dict, kind: str, rows: list, start: int = 0,
               n_valid: int = 0) -> float:
    tokens = len(rows) if kind == "decode" else n_valid
    return (decoder.step_flops(arch, kind, rows, start, n_valid)
            + 2 * shared_params(arch) * tokens)
