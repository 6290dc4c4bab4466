"""Parameters between the JAX reference's tree, as numpy arrays, and the
port's LM or encoder-decoder, both ways.

The reference stacks each layer-pattern position's leaves
``[n_groups, ...]``; the port holds one :class:`~repro_torch.models.lm.Block`
per layer, and layer ``group * period + pattern_index`` takes the slice
``groups[pattern_index][group]``.  The encoder-decoder's ``encoder`` and
``decoder`` leaves are stacked ``[n_encoder_layers, ...]`` /
``[n_decoder_layers, ...]``, and block ``i`` of each stack takes slice
``i``.  Leaves keep their shapes and dtypes;
bfloat16 arrays (numpy's ``ml_dtypes`` type) cross into the port as their
uint16 bits, and back out widened exactly to float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import encdec, lm
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


def _depths(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_depths(v) for v in tree.values()))
    return {np.shape(tree)[0]}


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


def _load_stack(blocks: list, tree: dict, name: str) -> None:
    """Slice ``i`` of every leaf of the stacked ``tree`` into
    ``blocks[i]``; the stack must hold exactly one slice a block."""
    if _depths(tree) != {len(blocks)}:
        raise ValueError(f"{name}: reference leaves stack "
                         f"{sorted(_depths(tree))} layers; the port has "
                         f"{len(blocks)}")
    for i, block in enumerate(blocks):
        load_module(block, _slice(tree, i))


def _check_keys(np_tree, top: set) -> None:
    if set(np_tree) != top:
        raise ValueError(f"reference tree keys {sorted(np_tree)} != "
                         f"{sorted(top)}")


def params_from_jax(np_tree, cfg: ModelConfig, device=None):
    """Build the port's LM (or, for ``family == "encdec"``, its
    :class:`~repro_torch.models.encdec.EncDec`) on ``device`` from the
    reference's parameter tree (``jax.tree.map(np.asarray, params)``).
    Every reference leaf must land on exactly one port parameter, and
    shapes and dtypes must agree."""
    if cfg.family == "encdec":
        model = encdec.EncDec(cfg, device=device)
        _check_keys(np_tree, {"embed", "encoder", "enc_norm", "decoder",
                              "dec_norm", "lm_head"})
        with torch.no_grad():
            _load(model.embed, np_tree["embed"], "embed")
            _load(model.lm_head, np_tree["lm_head"], "lm_head")
        load_module(model.enc_norm, np_tree["enc_norm"])
        load_module(model.dec_norm, np_tree["dec_norm"])
        _load_stack(list(model.encoder), np_tree["encoder"], "encoder")
        _load_stack(list(model.decoder), np_tree["decoder"], "decoder")
        return model
    model = lm.LM(cfg, device=device)
    with torch.no_grad():
        _load(model.embed, np_tree["embed"], "embed")
        if model.lm_head is not None:
            _load(model.lm_head, np_tree["lm_head"], "lm_head")
    load_module(model.final_norm, np_tree["final_norm"])
    _check_keys(np_tree, {"embed", "final_norm", "groups"} | (
        set() if model.lm_head is None else {"lm_head"}))
    if len(np_tree["groups"]) != cfg.period:
        raise ValueError(f"reference has {len(np_tree['groups'])} pattern "
                         f"positions; the config {cfg.period}")
    blocks = list(model.blocks)
    for p_idx in range(cfg.period):
        _load_stack(blocks[p_idx::cfg.period], np_tree["groups"][p_idx],
                    f"groups[{p_idx}]")
    return model


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (never a view of a parameter that trains on)."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _nest(named: dict) -> dict:
    tree: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _host(t)
    return tree


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(params, cfg: ModelConfig) -> dict:
    """The port's model (or a dict of tensors keyed by its parameter
    names, such as AdamW's moments) as the reference's parameter tree of
    numpy arrays (layer stacks ``[n, ...]``), bfloat16 leaves widened to
    float32, for a leaf-by-leaf comparison with the reference's state."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else params)
    stacks = ({"encoder": cfg.n_encoder_layers,
               "decoder": cfg.n_decoder_layers}
              if cfg.family == "encdec" else {"blocks": cfg.n_layers})
    tree = _nest({n: t for n, t in named.items()
                  if n.split(".", 1)[0] not in stacks})
    layers = {prefix: [_nest({n.split(".", 2)[2]: t
                              for n, t in named.items()
                              if n.startswith(f"{prefix}.{i}.")})
                       for i in range(n_layers)]
              for prefix, n_layers in stacks.items()}
    if cfg.family == "encdec":
        tree["encoder"] = _stack(layers["encoder"])
        tree["decoder"] = _stack(layers["decoder"])
    else:
        tree["groups"] = tuple(_stack(layers["blocks"][p_idx::cfg.period])
                               for p_idx in range(cfg.period))
    return tree
