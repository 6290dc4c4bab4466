"""The program's adapter for :mod:`reference` (copied beside it as
``perfbench/adapters/shared.py``): the port's MoE LM with
``n_shared_experts``, built by the decoder's adapter, the shared
expert's leaves placed in each layer's ``moe.shared``."""
from __future__ import annotations

import dataclasses

from perfbench.adapters import decoder


def model_config(arch: dict, name: str):
    return dataclasses.replace(decoder.model_config(arch, name),
                               n_shared_experts=arch["n_shared_experts"])


def place(block, w: dict) -> None:
    decoder.place(block, w)
    shared = block.moe.shared
    decoder.put(shared, "wi_gate", w["shared_gate"])
    decoder.put(shared, "wi_up", w["shared_up"])
    decoder.put(shared, "wo", w["shared_out"])


def build_lm(cfg, arch: dict, seed: int, device, ref):
    return decoder.build_lm(cfg, arch, seed, device, ref, place=place)
