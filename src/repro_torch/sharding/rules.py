"""Mesh sharding rules: parameters, optimizer state, inputs, decode caches,
activation constraints.

The twin of ``repro.sharding.rules`` on a ``torch.distributed``
``DeviceMesh`` with named dims (``data``, ``model`` and, multi-pod,
``pod``).  The strategy is the reference's:

* **FSDP x TP**: weight matrices are sharded 2-D, the contracting/input
  dim over ``data`` and the output/head/ffn dim over ``model``.
* **EP**: MoE expert stacks are sharded over ``model``; vocab embeddings
  likewise.
* **Multi-pod**: the ``pod`` axis extends data parallelism of the batch.
* **Decode caches**: batch over ``data`` when divisible, the cache
  sequence over ``model`` (or, for one sequence, over every axis).

A spec is a :class:`P`: one entry per tensor dim (trailing dims may be
left out), each ``None``, an axis name or a tuple of axis names.
:meth:`MeshRules.named` turns specs into DTensor placements, one per mesh
dim.

The reference's layers are stacked ``[G, ...]`` with a leading group dim;
the port keeps one module a layer (``models/lm.py``), so its parameter
and cache rules are the reference's with ``G`` dropped.  Parameters are
keyed by the module's parameter names (``blocks.3.attn.wq``), whose last
part is the reference's leaf name (``checkpoint/convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over ``data``.
    A one-axis tuple entry is stored as the axis, as JAX's
    ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def local_box(shape, mesh, placements) -> list[tuple[int, int]]:
    """[start, stop) per dim of this rank's shard of a tensor of ``shape``
    laid out on ``mesh`` by ``placements``."""
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    return [(o, o + n) for o, n in zip(offset, local)]


def even(placements, shape, sizes) -> list[Placement]:
    """``placements`` on a mesh of axis ``sizes`` with every dim that its
    axes do not divide evenly replicated.  An activation constraint pins
    these: JAX pads an uneven shard (12 heads over 16), while DTensor's
    views and ``local_map`` take shards to be even; replicating is the
    same value, computed on every rank of those axes."""
    ways: dict[int, int] = {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * sizes[i]
    return [Replicate() if isinstance(p, Shard) and shape[p.dim]
            % ways[p.dim] else p for p in placements]


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def map_tree(fn, tree):
    """``fn`` on every leaf of nested dicts / lists / tuples (a :class:`P`
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass
class MeshRules:
    """``mesh`` is a ``DeviceMesh`` (or anything with its ``shape`` and
    ``mesh_dim_names``: the rules read only axis names and sizes)."""

    mesh: Any
    multi_pod: bool = False
    # Megatron-style sequence parallelism: the residual stream is sharded
    # over "model" along seq
    sequence_parallel: bool = True
    fsdp: bool = True

    def _size(self, axis: str) -> int:
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    @property
    def dp(self):
        """Axes carrying the batch (data parallel)."""
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp:
            n *= self._size(a)
        return n

    @property
    def wd(self):
        """Axis sharding the weight contracting dim (FSDP)."""
        return "data" if self.fsdp else None

    def _axis_if_divisible(self, size: int, axis):
        if axis is None:
            return None
        n = 1
        for a in _axes(axis):
            n *= self._size(a)
        return axis if size % n == 0 else None

    # -- parameters ----------------------------------------------------------
    def _param_rule(self, names: list[str], shape: tuple) -> P:
        name = names[-1]
        ndim = len(shape)
        wd, mdl = self.wd, "model"
        if name == "embed":
            return P(self._axis_if_divisible(shape[0], mdl), None)
        if name == "lm_head":
            return P(None, self._axis_if_divisible(shape[1], mdl))
        if name == "router":
            return P(wd, None)
        if name in ("wk", "wv"):
            # KV projections replicated over "model": the head expansion
            # inside attention is then shard-local
            return P(wd, None)
        if name in ("wq", "wi", "wi_gate", "wi_up", "in_z", "in_x", "in_dt"):
            if ndim == 3:                      # MoE expert stack [E,d,f]
                return P(mdl, wd, None)
            return P(wd, mdl)                  # [d,out]
        if name in ("in_b", "in_c"):           # small SSD B/C streams
            return P(wd, None)
        if name in ("wo", "out_proj"):
            if ndim == 3:                      # [E,f,d]
                return P(mdl, None, wd)
            return P(mdl, wd)                  # [in,d]
        if name == "bq":
            return P(mdl)
        if name in ("bk", "bv"):
            return P(None)
        if name == "conv_x":
            return P(None, mdl)
        if name == "conv_bx":
            return P(mdl)
        return P()                             # norms, A_log, B/C convs, ...

    def param_specs(self, params_abs: torch.nn.Module) -> dict[str, P]:
        """{parameter name: spec} of a model (meta or real)."""
        return {n: self._param_rule(n.split("."), tuple(p.shape))
                for n, p in params_abs.named_parameters()}

    def state_specs(self, state_abs: dict) -> dict:
        """Optimizer state: moments shard like their parameters."""
        p_specs = self.param_specs(state_abs["params"])
        return {"params": p_specs, "m": p_specs, "v": p_specs, "step": P()}

    # -- inputs --------------------------------------------------------------
    def _batch_axis(self, b: int):
        return self.dp if b % self.dp_size == 0 else None

    def batch_specs(self, specs: dict) -> dict:
        return {k: P(self._batch_axis(v.shape[0]),
                     *([None] * (len(v.shape) - 1)))
                for k, v in specs.items()}

    # -- decode cache ---------------------------------------------------------
    def cache_specs(self, cache_abs: dict, batch: int) -> dict:
        """Specs of a legacy decode cache (``api.init_cache``): the LM's
        ``{"pos", "layers": [...]}`` or the encoder-decoder's stacked
        ``self_k`` ... ``cross_v`` [G,B,Hkv,S,Dh]."""
        b_ax = self._batch_axis(batch)
        seq_ax = "model" if b_ax is not None else ("data", "model")

        def rule(name: str, leaf) -> P:
            if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
                return P()
            if name in ("k", "v"):             # [B, Hkv, S, Dh]
                return P(b_ax, None,
                         self._axis_if_divisible(leaf.shape[2], seq_ax), None)
            if name in ("self_k", "self_v", "cross_k", "cross_v"):
                return P(None, b_ax, None,     # [G, B, Hkv, S, Dh]
                         self._axis_if_divisible(leaf.shape[3], seq_ax), None)
            if name in ("k_scale", "v_scale"):  # [B, Hkv, S]
                return P(b_ax, None,
                         self._axis_if_divisible(leaf.shape[2], seq_ax))
            if name == "state":               # [B, H, P, N]
                return P(b_ax, self._axis_if_divisible(leaf.shape[1], "model"),
                         None, None)
            if name == "conv_x":              # [B, W-1, d_inner]
                return P(b_ax, None,
                         self._axis_if_divisible(leaf.shape[2], "model"))
            if name in ("conv_b", "conv_c"):  # [B, W-1, N] (small)
                return P(b_ax, None, None)
            return P()

        def walk(tree, name=""):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, name) for v in tree)
            return rule(name, tree)

        return walk(cache_abs)

    # -- activation constraints (installed via sharding.ctx) ------------------
    def constraint_spec(self, shape: tuple, kind: str) -> P | None:
        """The spec ``constrain(x, kind)`` pins for an ``x`` of ``shape``;
        None where the kind does not apply (``x`` passes unchanged)."""
        dp = self.dp
        sp = "model" if self.sequence_parallel else None
        ndim = len(shape)

        def b_ax(b):
            return dp if b % self.dp_size == 0 else None

        if kind == "activations" and ndim == 3:
            seq_ok = sp and shape[1] % self._size("model") == 0
            return P(b_ax(shape[0]), sp if seq_ok else None, None)
        if kind == "logits" and ndim == 3:
            return P(b_ax(shape[0]), None, "model")
        if kind == "decode_logits" and ndim == 2:
            return P(b_ax(shape[0]), "model")
        if kind == "expert_tokens":            # [E, G, C, D]
            return P("model", b_ax(shape[1]), None, None)
        if kind == "attn_heads" and ndim == 4:
            # [B, H, S, D]: full-head layout used throughout flash
            return P(b_ax(shape[0]), "model", None, None)
        if kind == "attn_kv_rep" and ndim == 4:
            # [B, Hkv, S, D]: KV heads replicated over "model"
            return P(b_ax(shape[0]), None, None, None)
        if kind == "ssd_xs5" and ndim == 5:    # [nc, B, Q, H, P]
            return P(None, b_ax(shape[1]), None,
                     self._axis_if_divisible(shape[3], "model"), None)
        if kind == "ssd_xs4" and ndim == 4:    # [nc, B, Q, H]
            return P(None, b_ax(shape[1]), None,
                     self._axis_if_divisible(shape[3], "model"))
        if kind == "ssd_state" and ndim == 4:  # [B, H, P, N]
            return P(b_ax(shape[0]),
                     self._axis_if_divisible(shape[1], "model"), None, None)
        if kind == "ssd_y" and ndim == 4:      # [B, Q, H, P]
            return P(b_ax(shape[0]), None,
                     self._axis_if_divisible(shape[2], "model"), None)
        return None

    def constrain_fn(self):
        """``fn(x, kind)``: a DTensor redistributed onto the kind's
        placements; a plain tensor (a local shard inside a ``local_map``
        region, or a run without a mesh) unchanged, as the reference's
        constraint is the identity outside pjit."""

        def fn(x, kind: str):
            if not isinstance(x, DTensor):
                return x
            pl = placements(tuple(x.shape), kind)
            return x if pl is None else x.redistribute(x.device_mesh, pl)

        def placements(shape: tuple, kind: str):
            spec = self.constraint_spec(shape, kind)
            return None if spec is None else even(
                self.placements(spec, shape), shape, self.mesh.shape)

        fn.placements = placements      # read by sharding.layout
        return fn

    # -- helpers ---------------------------------------------------------------
    def placements(self, spec: P, shape=None) -> list[Placement]:
        """DTensor placements (one per mesh dim) of ``spec``.  A tensor dim
        sharded over several axes takes ``Shard(d)`` on each, in mesh-dim
        order (``pod`` major), which is JAX's order.  Given the tensor's
        ``shape``, a dim of size 1 stays replicated: only axes of size 1
        divide it, where a shard moves nothing, and DTensor refuses to view
        a sharded dim of size 1 away (``[1, S, D] -> [S, D]``)."""
        names = list(self.mesh.mesh_dim_names)
        out: list[Placement] = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if shape is not None and shape[d] == 1:
                continue
            idx = [names.index(a) for a in _axes(entry)]
            if idx != sorted(idx):
                raise ValueError(f"{spec}: {entry} is not in mesh-dim order "
                                 f"{names}; DTensor shards a dim over "
                                 f"several axes major to minor by mesh dim")
            for a in _axes(entry):
                i = names.index(a)
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"{spec}: axis {a!r} shards two dims")
                out[i] = Shard(d)
        return out

    def named(self, spec_tree):
        """The placements of every spec of a tree of specs."""
        return map_tree(self.placements, spec_tree)
