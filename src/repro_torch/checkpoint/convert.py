"""Parameters of the JAX reference, as numpy arrays, into the port's LM.

The reference stacks each layer-pattern position's leaves
``[n_groups, ...]``; the port holds one :class:`~repro_torch.models.lm.Block`
per layer, and layer ``group * period + pattern_index`` takes the slice
``groups[pattern_index][group]``.  Leaves keep their shapes and dtypes;
bfloat16 arrays (numpy's ``ml_dtypes`` type) cross as their uint16 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.types import ModelConfig


def to_tensor(a) -> torch.Tensor:
    """A numpy array (possibly bfloat16, possibly read-only) as a tensor
    that owns a copy of its data."""
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(tree, dotted: str):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def _load(param: torch.Tensor, value, name: str) -> None:
    """Copy one leaf into one parameter, refusing a shape or dtype change."""
    t = to_tensor(value)
    if t.shape != param.shape or t.dtype != param.dtype:
        raise ValueError(f"{name}: reference leaf {tuple(t.shape)} {t.dtype} "
                         f"!= port parameter {tuple(param.shape)} "
                         f"{param.dtype}")
    param.copy_(t)


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def _slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]


def load_module(module: torch.nn.Module, tree: dict) -> None:
    """Copy a reference parameter dict into ``module``, whose parameter
    names are the dict's paths (``attn.wq`` <- ``tree["attn"]["wq"]``).
    Every leaf must land on exactly one parameter."""
    n = 0
    with torch.no_grad():
        for name, param in module.named_parameters():
            _load(param, _leaf(tree, name), name)
            n += 1
    if n != _n_leaves(tree):
        raise ValueError(f"reference tree has {_n_leaves(tree)} leaves; "
                         f"{type(module).__name__} has {n} parameters")


def params_from_jax(np_tree, cfg: ModelConfig, device=None) -> lm.LM:
    """Build the port's LM on ``device`` from the reference's parameter
    tree (``jax.tree.map(np.asarray, params)``).  Every reference leaf must
    land on exactly one port parameter, and shapes and dtypes must agree."""
    model = lm.LM(cfg, device=device)
    with torch.no_grad():
        _load(model.embed, np_tree["embed"], "embed")
        if model.lm_head is not None:
            _load(model.lm_head, np_tree["lm_head"], "lm_head")
    load_module(model.final_norm, np_tree["final_norm"])
    top = {"embed", "final_norm", "groups"} | (
        set() if model.lm_head is None else {"lm_head"})
    if set(np_tree) != top:
        raise ValueError(f"reference tree keys {sorted(np_tree)} != "
                         f"{sorted(top)}")
    for layer, block in enumerate(model.blocks):
        group, p_idx = divmod(layer, cfg.period)
        load_module(block, _slice(np_tree["groups"][p_idx], group))
    return model
