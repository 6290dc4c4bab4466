"""Train / serve step functions and their sharding assembly.

The twin of ``repro.launch.steps``.  ``build_train_step`` /
``build_serve_step`` / ``build_prefill_step`` return a :class:`BuiltStep`
(the step, abstract inputs on the meta device, their placements and the
rules), so the same assembly serves the launcher and the host-mesh tests.
Where the reference jits with ``in_shardings``, the port's step places
its inputs onto the rules' mesh as DTensors
(:mod:`repro_torch.runtime.elastic`; a no-op for inputs already placed)
and runs under the rules' activation constraints; the state it returns
stays on its input placements, as the reference's ``out_shardings`` pins
it.

The reference jits its steps and donates the state / cache argument so
they update in place; PyTorch runs eagerly, and the steps here update the
optimizer state and the cache tensors in place themselves (see
:mod:`repro_torch.optim.adamw` and
:mod:`repro_torch.models.paged_lm`), returning them.  Serve shapes are
still fixed at build time (slot count, padded cache length, prefill
chunk), whatever the batch composition.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import sharding as shard_ctx
from repro_torch.models import api
from repro_torch.models.types import ModelConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import reshard
from repro_torch.sharding.rules import MeshRules, P, map_tree


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=lr, moment_dtype=cfg.adam_dtype)


def _grads(loss: torch.Tensor, leaves) -> tuple:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not
    use (an embeddings-input model's token table), as ``jax.grad`` gives.
    A DTensor leaf's gradient comes back on the leaf's own placements
    (the FSDP reduce-scatter)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return tuple(g.redistribute(p.device_mesh, p.placements)
                 if isinstance(p, DTensor) else g
                 for g, p in zip(grads, leaves))


def _microbatches(v: torch.Tensor, accum: int) -> list:
    """v [B, ...] as ``accum`` microbatches of consecutive rows [B / accum,
    ...], as the reference splits them.  A batch sharded over the data
    axes (a DTensor) moves its shards to the next dim first (an
    all-to-all; a gather where that dim does not divide), is cut there,
    and each microbatch goes back to the batch's placements: DTensor
    cannot view a sharded B as [accum, B / accum] when accum is smaller
    than the axes."""
    b = v.shape[0]
    if not isinstance(v, DTensor):
        return list(v.reshape(accum, b // accum, *v.shape[1:]))
    mesh, pl = v.device_mesh, list(v.placements)
    ways = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(0))
    apart = Shard(1) if v.ndim > 1 and v.shape[1] % ways == 0 \
        else Replicate()
    w = v.redistribute(mesh, [apart if p == Shard(0) else p for p in pl])
    w = w.reshape(accum, b // accum, *v.shape[1:])
    return [w[i].redistribute(mesh, pl) for i in range(accum)]


def train_step(state: dict, batch: dict, cfg: ModelConfig,
               opt: adamw.AdamWConfig, transform=None, *, device=None):
    """Loss + grads + AdamW update; returns (state, metrics), the state
    updated in place.  ``batch`` moves to ``device`` (the card when None).

    ``cfg.accum_steps > 1`` runs gradient accumulation: the batch is split
    into microbatches run one after another, their gradients summed in
    float32 (bf16 leaves have bf16 grads, as in the reference)."""
    params = state["params"]
    names, leaves = zip(*params.named_parameters())
    batch = api.batch_to(batch, device)
    accum = max(1, cfg.accum_steps)
    if accum == 1:
        loss = api.train_loss(params, batch, cfg, device=device)
        grads = _grads(loss, leaves)
    else:
        micro = {k: _microbatches(v, accum) for k, v in batch.items()}
        # laid out as the leaves (a DTensor leaf's placements too)
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        losses = []
        for i in range(accum):
            mb = {k: v[i] for k, v in micro.items()}
            l = api.train_loss(params, mb, cfg, device=device)
            for acc, g in zip(grads, _grads(l, leaves)):
                acc.add_(g.float())
            losses.append(l.detach())
        grads = [g / accum for g in grads]
        loss = sum(losses[1:], losses[0]) / accum
    grads = dict(zip(names, grads))
    state = adamw.apply_updates(state, grads, cfg=opt, transform=transform)
    metrics = {"loss": loss.detach(), "grad_norm": adamw.global_norm(grads)}
    return state, metrics


def serve_step(params, tokens, cache, cfg: ModelConfig):
    """One legacy lockstep decode step: (logits [B, V] float32, cache),
    the cache updated in place on its own device."""
    return api.decode(params, tokens, cache, cfg)


def prefill_step(params, batch: dict, cfg: ModelConfig, *, device=None):
    """Last-position logits [B, V] float32 of ``batch`` (moved to
    ``device``, the card when None)."""
    return api.prefill(params, batch, cfg, device=device)


@dataclasses.dataclass
class BuiltStep:
    fn: Any                   # the step, placing its inputs
    args_abs: tuple           # abstract example args (meta tensors)
    in_shardings: tuple       # their placements (trees of lists)
    rules: MeshRules
    in_specs: tuple = ()      # their specs (trees of P), for ``reshard``


def abstract_state(cfg: ModelConfig, opt: adamw.AdamWConfig) -> dict:
    """The optimizer state of ``cfg`` on the meta device."""
    return adamw.init_state(api.abstract_params(cfg), opt)


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, rules: MeshRules,
                     transform=None) -> BuiltStep:
    """``fn(state, batch) -> (state, metrics)``: the state placed by
    ``state_specs`` (in place: the model's parameters become DTensors),
    the batch by ``batch_specs``; metrics are plain replicated scalars."""
    opt = make_optimizer(cfg)
    state_abs = abstract_state(cfg, opt)
    batch_abs = api.input_specs(cfg, shape)
    state_specs = rules.state_specs(state_abs)
    batch_specs = rules.batch_specs(batch_abs)
    device = rules.mesh.device_type

    def fn(state, batch):
        state = reshard(state, rules, state_specs)
        batch = reshard(api.batch_to(batch, device), rules, batch_specs)
        with shard_ctx.constrainer(rules.constrain_fn()):
            state, metrics = train_step(state, batch, cfg, opt, transform,
                                        device=device)
        state = reshard(state, rules, state_specs)
        return state, {k: shard_ctx.full(v) for k, v in metrics.items()}

    return BuiltStep(fn, (state_abs, batch_abs),
                     (rules.named(state_specs), rules.named(batch_specs)),
                     rules, (state_specs, batch_specs))


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig,
                     rules: MeshRules) -> BuiltStep:
    """``fn(params, tokens, cache) -> (logits, cache)``: one lockstep
    decode step, the cache placed by ``cache_specs`` (the host-int
    position stays a host int)."""
    params_abs = api.abstract_params(cfg)
    cache_abs = api.abstract_cache(cfg, shape)
    tokens_abs = api.input_specs(cfg, shape)["tokens"]
    params_specs = rules.param_specs(params_abs)
    cache_specs = rules.cache_specs(cache_abs, shape.global_batch)
    tokens_spec = rules.batch_specs({"tokens": tokens_abs})["tokens"]
    device = rules.mesh.device_type

    def fn(params, tokens, cache):
        params = reshard(params, rules, params_specs)
        if not api.is_meta(tokens):
            tokens = torch.as_tensor(tokens, device=device)
        tokens = reshard(tokens, rules, tokens_spec)
        cache = reshard(cache, rules, cache_specs)
        with shard_ctx.constrainer(rules.constrain_fn()):
            return serve_step(params, tokens, cache, cfg)

    return BuiltStep(fn, (params_abs, tokens_abs, cache_abs),
                     (rules.named(params_specs), rules.named(tokens_spec),
                      rules.named(cache_specs)), rules,
                     (params_specs, tokens_spec, cache_specs))


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       rules: MeshRules) -> BuiltStep:
    """``fn(params, batch) -> logits [B, V]``."""
    params_abs = api.abstract_params(cfg)
    batch_abs = api.input_specs(cfg, shape)
    params_specs = rules.param_specs(params_abs)
    batch_specs = rules.batch_specs(batch_abs)
    device = rules.mesh.device_type

    def fn(params, batch):
        params = reshard(params, rules, params_specs)
        batch = reshard(api.batch_to(batch, device), rules, batch_specs)
        with shard_ctx.constrainer(rules.constrain_fn()):
            return prefill_step(params, batch, cfg, device=device)

    return BuiltStep(fn, (params_abs, batch_abs),
                     (rules.named(params_specs), rules.named(batch_specs)),
                     rules, (params_specs, batch_specs))


@dataclasses.dataclass
class ServeSteps:
    """Step pair + cache factory for the continuous-batching engine.

    ``decode(params, tokens, active, temps, key_data, cache)`` and
    ``prefill(params, tokens, n_valid, slot, temp, key_data, cache)`` both
    update ``cache`` in place and return it as their last output.
    """

    decode: Any
    prefill: Any
    init_cache: Any          # () -> zeroed serve cache on the device


def build_serve_engine_steps(cfg: ModelConfig, *, slots: int, max_len: int,
                             backend: str = "paged", page_size: int = 16,
                             n_pages: int | None = None,
                             attn_read: str = "gather",
                             sampling: bool = True,
                             return_logits: bool = False,
                             rules: MeshRules | None = None,
                             device=None) -> ServeSteps:
    """Assemble the continuous-batching serve steps (paged or dense cache)
    for a cache on ``device``.

    With ``rules`` the model's activation constraints are installed and
    the cache lives on the rules' mesh, replicated (the reference gives
    the paged pools no spec); the params are expected on that mesh
    (placed by ``param_specs``).  Without, the steps are plain calls."""
    if attn_read not in ("gather", "kernel"):
        raise ValueError(f"unknown attn_read {attn_read!r}")
    if attn_read == "kernel" and backend != "paged":
        raise ValueError("attn_read='kernel' reads the paged pools; "
                         "use backend='paged'")

    def ctx():
        return (shard_ctx.constrainer(rules.constrain_fn()) if rules
                else contextlib.nullcontext())

    def make_cache():
        cache = api.init_serve_cache(cfg, slots=slots, max_len=max_len,
                                     backend=backend, page_size=page_size,
                                     n_pages=n_pages, device=device)
        if rules is None:
            return cache
        return reshard(cache, rules, map_tree(lambda _: P(), cache))

    def decode_fn(params, tokens, active, temps, key_data, cache):
        with ctx():
            return api.serve_decode(params, tokens, active, temps, key_data,
                                    cache, cfg, attn_read=attn_read,
                                    sampling=sampling,
                                    return_logits=return_logits)

    def prefill_fn(params, tokens, n_valid, slot, temp, key_data, cache):
        with ctx():
            return api.serve_prefill(params, tokens, n_valid, slot, temp,
                                     key_data, cache, cfg, sampling=sampling,
                                     return_logits=return_logits)

    return ServeSteps(decode=decode_fn, prefill=prefill_fn,
                      init_cache=make_cache)


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               rules: MeshRules) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, shape, rules)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, rules)
    return build_serve_step(cfg, shape, rules)
