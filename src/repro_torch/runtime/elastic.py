"""Elastic scaling: re-shard a state onto a (possibly different) mesh.

The twin of ``repro.runtime.elastic``.  When ranks are lost or gained the
job restarts on a new mesh; leaves keep their *logical* specs and only
the placement changes.  ``reshard`` moves a live state: each leaf (a
DTensor on any mesh, or a plain tensor every rank holds whole) is taken
to the full tensor and distributed onto the rules' mesh with its spec,
every rank cutting its own shard (no scatter).  Values never change.
Checkpoint-based elasticity goes through
:meth:`repro_torch.checkpoint.checkpointer.Checkpointer.restore` into a
target on the new mesh.

An ``nn.Module`` leaf is resharded in place: each parameter is replaced
by a parameter over the new DTensor, keeping ``requires_grad``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.sharding.rules import MeshRules, P


def _same_mesh(a, b) -> bool:
    return (a.device_type == b.device_type
            and a.mesh_dim_names == b.mesh_dim_names
            and torch.equal(a.mesh, b.mesh))


@torch.no_grad()
def _leaf(x, rules: MeshRules, spec: P):
    if not isinstance(x, torch.Tensor):
        return x
    placements = rules.placements(spec, x.shape)
    if isinstance(x, DTensor):
        if (_same_mesh(x.device_mesh, rules.mesh)
                and list(x.placements) == placements):
            return x
        x = x.full_tensor()
    return distribute_tensor(x, rules.mesh, placements,
                             src_data_rank=None)


def _module(m: nn.Module, rules: MeshRules, specs: dict) -> nn.Module:
    for owner_name, owner in m.named_modules():
        for name, p in list(owner.named_parameters(recurse=False)):
            full = f"{owner_name}.{name}" if owner_name else name
            new = _leaf(p, rules, specs[full])
            if new is not p:
                setattr(owner, name,
                        nn.Parameter(new, requires_grad=p.requires_grad))
    return m


def reshard(tree: Any, rules: MeshRules, spec_tree: Any) -> Any:
    """Every tensor leaf of ``tree`` on ``rules.mesh`` with its spec from
    ``spec_tree`` (a tree of the same structure; a module's is
    ``{parameter name: spec}``).  Leaves already placed so are kept."""
    if isinstance(tree, nn.Module):
        return _module(tree, rules, spec_tree)
    if isinstance(tree, dict):
        return {k: reshard(v, rules, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard(v, rules, s)
                          for v, s in zip(tree, spec_tree))
    return _leaf(tree, rules, spec_tree)


def reshard_state(state: Any, rules: MeshRules) -> Any:
    return reshard(state, rules, rules.state_specs(state))
