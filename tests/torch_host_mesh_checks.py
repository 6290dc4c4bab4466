"""The port's host-mesh checks: the twins of tests/host_mesh_checks.py on
ranks of a gloo group (one CPU process a rank) instead of host devices.

Run by tests/test_torch_host_mesh.py and tests/test_torch_mesh_steps.py:

    python tests/torch_host_mesh_checks.py --group mesh --out result.json

spawns the group's ranks (4 for ``mesh``, ``sequence_parallel``,
``families``, ``dryrun`` and ``sequence_parallel_families``, 1 for
``steps``) that meet through a ``FileStore`` next to
``--out`` (no TCP
port, so several runs can go at once), runs the group's checks on all
ranks, and has rank 0 write one JSON object,
``{check: {"ok": bool, ...numbers or "error"}}``.  Every collective times
out after ``TIMEOUT_S``, so a rank that fails cannot hang the others for
long.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import pathlib
import sys
import tempfile
import time
import traceback
import types

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import sharding  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api, encdec, paged_lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.types import ShapeConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.elastic import reshard, reshard_state  # noqa: E402
from repro_torch.runtime.fault_tolerance import (SimulatedFailure,  # noqa
                                                 TrainDriver)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.sharding.rules import MeshRules  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard, distribute_tensor)

SHAPE = ShapeConfig("tiny_train", "train", seq_len=64, global_batch=8)
ARCH = "qwen2-1.5b"
SEED, BATCH_SEED = 0, 7
TIMEOUT_S = 120


# the families group's archs: (registry name, smoke changes).  jamba is
# cut to its first 4 layers, the fewest that hold an SSM, an attention and
# an MoE block (a period of 4 keeps its pattern's first 4 positions and
# the reference's rule that the period divides the depth), and to one
# microbatch (its 8 leave 1 row each, which no data axis can shard)
FAMILIES = {"dbrx": ("dbrx-132b", {}), "mamba2": ("mamba2-2.7b", {}),
            "jamba": ("jamba-1.5-large-398b",
                      {"n_layers": 4, "period": 4, "accum_steps": 1}),
            "whisper": ("whisper-small", {})}


def smoke(arch=ARCH, **changes):
    return dataclasses.replace(registry.smoke(arch), **changes)


def tiny_setup(data=2, model=2, seed=SEED, dtype=None,
               sequence_parallel=False, cfg=None):
    cfg = cfg or smoke()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    rules = MeshRules(make_host_mesh(data, model),
                      sequence_parallel=sequence_parallel)
    built = steps.build_train_step(cfg, SHAPE, rules)
    state = reshard_state(plain_state(cfg, seed), rules)
    return cfg, rules, built, state


def plain_state(cfg, seed=SEED):
    params = api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return adamw.init_state(params, steps.make_optimizer(cfg))


def batch_fn(cfg):
    return lambda step: synthetic_batch(cfg, SHAPE, seed=BATCH_SEED,
                                        step=step)


def leaves(state):
    return ([p for _, p in state["params"].named_parameters()]
            + list(state["m"].values()) + list(state["v"].values())
            + [state["step"]])


def full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def same_bits(a, b) -> bool:
    a, b = full(a), full(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def check_sharded_train_step(tmp):
    """One sharded step of the smoke config (bfloat16): its loss, for the
    test to hold against the reference's single-device loss; then one
    sharded step in float32 against the port's unsharded ``train_step``
    from the same state: the loss and every leaf of the new state."""
    cfg, _, built, state = tiny_setup()
    _, metrics = built.fn(state, batch_fn(cfg)(0))
    return {"loss": float(metrics["loss"]), **f32_step_vs_plain()}


def check_sequence_parallel_train_step(tmp):
    """The float32 comparison with the residual stream's sequence sharded
    over "model" (the rules' default)."""
    return f32_step_vs_plain(sequence_parallel=True)


def f32_step_vs_plain(sequence_parallel=False, cfg=None,
                      mesh=(2, 2)) -> dict:
    """One sharded float32 step against the port's unsharded
    ``train_step`` from the same state: loss, grad norm and every leaf."""
    cfg, _, built, state = tiny_setup(*mesh, dtype="float32",
                                      sequence_parallel=sequence_parallel,
                                      cfg=cfg)
    batch = batch_fn(cfg)(0)
    state, metrics = built.fn(state, batch)
    opt = steps.make_optimizer(cfg)
    ref, ref_metrics = steps.train_step(plain_state(cfg), batch, cfg, opt,
                                        device="cpu")
    params = zip(state["params"].parameters(), ref["params"].parameters())
    moments = [(state[k][n], ref[k][n]) for k in ("m", "v") for n in ref[k]]
    out = dict(
        f32_loss=float(metrics["loss"]),
        f32_plain_loss=float(ref_metrics["loss"]),
        f32_grad_norm=float(metrics["grad_norm"]),
        f32_plain_grad_norm=float(ref_metrics["grad_norm"]),
        param_max_abs=max(float((full(a) - b.detach()).abs().max())
                          for a, b in params),
        moment_max_rel_norm=max(float((full(a) - b).norm() / b.norm())
                                for a, b in moments if b.norm() > 0),
        lr=float(adamw.schedule(opt, torch.ones((), dtype=torch.int32))),
        step_equal=int(full(state["step"])) == int(ref["step"]),
        placed=all(isinstance(t, DTensor) for t in leaves(state)))
    out["ok"] = out["placed"] and out["step_equal"]
    return out


def check_checkpoint_roundtrip(tmp):
    cfg, rules, built, state = tiny_setup()
    ck = Checkpointer(tmp / "ckpt", host_id=dist.get_rank(),
                      n_hosts=dist.get_world_size())
    state, _ = built.fn(state, batch_fn(cfg)(0))
    ck.save(1, state, blocking=True)
    target = reshard_state(plain_state(cfg, seed=1), rules)
    restored = ck.restore(1, target)
    ok = all(same_bits(a, b) for a, b in zip(leaves(state), leaves(restored)))
    # and onto another mesh shape: each rank reads the boxes it now owns
    rules2 = MeshRules(make_host_mesh(4, 1), sequence_parallel=False)
    other = ck.restore(1, reshard_state(plain_state(cfg, seed=2), rules2))
    other_ok = all(same_bits(a, b)
                   for a, b in zip(leaves(state), leaves(other)))
    moved = all(tuple(t.device_mesh.shape) == (4, 1) for t in leaves(other))
    return {"ok": ok and other_ok and moved, "same_mesh": ok,
            "other_mesh": other_ok, "steps": ck.all_steps()}


def check_crash_resume_bitwise(tmp):
    cfg, rules, built, state0 = tiny_setup()
    rank, world = dist.get_rank(), dist.get_world_size()

    def driver(name):
        ck = Checkpointer(tmp / name, host_id=rank, n_hosts=world)
        return TrainDriver(built.fn, batch_fn(cfg), ck, checkpoint_every=3)

    ref_state, ref_hist = driver("ref").run(state0, 8)
    crashed = driver("crash")
    try:
        crashed.run(tiny_setup()[3], 8, fail_at=5)
        return {"ok": False, "error": "failure not raised"}
    except SimulatedFailure:
        pass
    target = reshard_state(plain_state(cfg, seed=9), rules)
    resumed, hist = crashed.resume(target, 8)
    ok = (hist == ref_hist[hist[0]["step"]:]
          and all(same_bits(a, b)
                  for a, b in zip(leaves(ref_state), leaves(resumed))))
    return {"ok": ok, "resumed_from": hist[0]["step"],
            "last_loss": hist[-1]["loss"],
            "ref_last_loss": ref_hist[-1]["loss"]}


def check_elastic_reshard(tmp):
    cfg, rules, built, state = tiny_setup()
    state, m1 = built.fn(state, batch_fn(cfg)(0))
    rules2 = MeshRules(make_host_mesh(4, 1), sequence_parallel=False)
    state2 = reshard_state(state, rules2)
    built2 = steps.build_train_step(cfg, SHAPE, rules2)
    _, m2 = built2.fn(state2, batch_fn(cfg)(1))
    return {"ok": math.isfinite(float(m2["loss"])),
            "loss_a": float(m1["loss"]), "loss_b": float(m2["loss"])}


def check_reshard_roundtrip(tmp):
    """(2, 2) -> (1, 4) -> (2, 2) moves bytes, never values, and lands back
    on the original placements."""
    cfg, rules, built, state = tiny_setup()
    state, _ = built.fn(state, batch_fn(cfg)(0))
    snap = [full(t).clone() for t in leaves(state)]
    placements = [t.placements for t in leaves(state)]
    rules2 = MeshRules(make_host_mesh(1, 4), sequence_parallel=False)
    state_b = reshard_state(state, rules2)
    ok_b = all(same_bits(a, b) for a, b in zip(snap, leaves(state_b)))
    moved = all(tuple(t.device_mesh.shape) == (1, 4)
                for t in leaves(state_b))
    state_a = reshard_state(state_b, rules)
    ok_a = all(same_bits(a, b) for a, b in zip(snap, leaves(state_a)))
    same_pl = all(tuple(p) == tuple(t.placements)
                  for p, t in zip(placements, leaves(state_a)))
    return {"ok": ok_b and ok_a and same_pl and moved, "there": ok_b,
            "back": ok_a, "placements_back": same_pl, "moved": moved}


def check_engine_under_mesh(tmp):
    """The engine with rules on a (1, 1) mesh: the params and cache become
    DTensors, the greedy tokens equal the engine's without rules."""
    cfg = registry.smoke(ARCH)
    prompts = ([1, 2, 3], [5, 6, 7, 8, 9, 10, 11, 12, 13], [4])
    out = {}
    for name, rules in (("plain", None),
                        ("mesh", MeshRules(make_host_mesh(1, 1)))):
        params = api.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
        eng = ServeEngine(cfg, params, slots=2, max_len=32, page_size=8,
                          prefill_chunk=8, rules=rules, device="cpu")
        rs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        out[name] = [list(r.out_tokens) for r in rs]
        out[f"{name}_dtensor"] = isinstance(eng.params.embed, DTensor) \
            and isinstance(eng.cache["layers"][0]["k_pages"], DTensor)
    out["ok"] = (out["plain"] == out["mesh"] and out["mesh_dtensor"]
                 and all(len(t) == 4 for t in out["mesh"]))
    return out


def check_paged_read_model_sharded_heads(tmp):
    """Query heads sharded over a "model" axis of 2 and of 4, for 8 query
    heads on 4 KV heads and 4 on 2: a shard of several KV heads, of one,
    and shards sharing one.  Each rank reads its heads' KV heads from the
    whole replicated pool; the result equals the unsharded read bit for
    bit."""
    gen = torch.Generator().manual_seed(5)
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lengths = torch.tensor([9, 40], dtype=torch.int32)
    out = {}
    for model in (2, 4):
        mesh = make_host_mesh(4 // model, model)
        rep = [Replicate()] * 2
        for h, hkv in ((8, 4), (4, 2)):
            q = torch.randn(2, h, 16, generator=gen)
            kp, vp = (torch.randn(7, 16, hkv, 16, generator=gen)
                      for _ in range(2))
            want = paged_lm._paged_read(q, kp, vp, table, lengths)
            got = paged_lm._paged_read(
                distribute_tensor(q, mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None),
                *(distribute_tensor(t, mesh, rep, src_data_rank=None)
                  for t in (kp, vp, table, lengths)))
            out[f"model{model}_h{h}_kv{hkv}"] = (
                isinstance(got, DTensor) and same_bits(got, want))
    out["ok"] = all(out.values())
    return out


def check_family_steps(arch, changes) -> dict:
    """One family at (2, 2): a sharded bfloat16 train step's loss, for the
    test to hold against the reference's single-device loss; a sharded
    float32 step against the unsharded one; then, in float32, ``build_step``
    prefill (at the shape of one training microbatch) and 3 lockstep decode
    steps against the plain steps (whisper's cross K/V precomputed from
    one plain encoding, in both caches)."""
    cfg = smoke(arch, **changes)
    _, rules, built, state = tiny_setup(cfg=cfg)
    _, metrics = built.fn(state, batch_fn(cfg)(0))
    out = {"loss": float(metrics["loss"])}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out.update(f32_step_vs_plain(cfg=cfg32))

    params = api.init_params(cfg32, torch.Generator().manual_seed(SEED),
                             "cpu")
    out.update(prefill_vs_plain(cfg32, rules, params))

    b, s = 2, 32
    decode = ShapeConfig("d", "decode", seq_len=s, global_batch=b)
    plain = api.init_params(cfg32, torch.Generator().manual_seed(SEED), "cpu")
    built = steps.build_step(cfg32, decode, rules)
    tokens = torch.tensor([[3], [7]], dtype=torch.int32)
    cache, ref_cache = (api.init_cache(cfg32, b, s, device="cpu")
                        for _ in range(2))
    if cfg.family == "encdec":
        frames = torch.randn(b, cfg.cross_len, cfg.d_model,
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            cross = encdec.precompute_cross(
                plain, encdec.encode(plain, frames, cfg32), cfg32)
        for c in (cache, ref_cache):
            c["cross_k"], c["cross_v"] = (t.clone() for t in cross)
    errs, scale = [], 0.0
    for _ in range(3):
        logits, cache = built.fn(params, tokens, cache)
        ref, ref_cache = steps.serve_step(plain, tokens, ref_cache, cfg32)
        errs.append(float((full(logits) - ref).abs().max()))
        scale = max(scale, float(ref.abs().max()))
        tokens = ref.argmax(-1, keepdim=True).to(torch.int32)
    out.update(decode_errs=errs, decode_scale=scale,
               moe=cfg.n_experts > 0,
               cache_dtensor=all(isinstance(t, DTensor) for t in leaves_of(
                   cache)))
    out["ok"] = out["ok"] and out["cache_dtensor"]
    return out


def prefill_vs_plain(cfg32, rules, params=None) -> dict:
    """``build_step`` prefill (float32, at the shape of one training
    microbatch) against the plain ``prefill_step``: the largest logit
    difference and the largest plain logit."""
    params = params or api.init_params(
        cfg32, torch.Generator().manual_seed(SEED), "cpu")
    prefill = ShapeConfig("p", "prefill", seq_len=SHAPE.seq_len,
                          global_batch=SHAPE.global_batch
                          // max(1, cfg32.accum_steps))
    batch = synthetic_batch(cfg32, prefill, seed=BATCH_SEED, step=0)
    batch.pop("labels", None)
    want = steps.prefill_step(params, batch, cfg32, device="cpu")
    got = full(steps.build_step(cfg32, prefill, rules).fn(params, batch))
    return {"prefill_err": float((got - want).abs().max()),
            "prefill_scale": float(want.abs().max())}


def leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves_of(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _family_check(name):
    def check(tmp):
        return check_family_steps(*FAMILIES[name])

    check.__name__ = f"check_family_{name}"
    return check


def check_moe_groups_over_data(tmp):
    """``apply_moe`` (dbrx smoke, float32) on DTensor tokens sharded over
    data at (2, 2) under the rules, forward and gradients against the
    plain call: 4 groups, which divide over data (each rank routes its
    own), and 1 group of 32 tokens, which does not (the rule replicates
    G, and so does the region)."""
    cfg = smoke("dbrx-132b", dtype="float32")
    rules = MeshRules(make_host_mesh(2, 2), sequence_parallel=False)
    block = api.init_params(cfg, torch.Generator().manual_seed(SEED),
                            "cpu").blocks[0].moe
    specs = {n: rules.param_specs(block).get(n) for n, _ in
             block.named_parameters()}
    out = {}
    for name, (b, s) in (("groups_divide", (4, 64)),
                         ("group_replicated", (2, 16))):
        x = torch.randn(b, s, cfg.d_model,
                        generator=torch.Generator().manual_seed(b))
        dy = torch.randn(b, s, cfg.d_model,
                         generator=torch.Generator().manual_seed(b + 1))
        plain = {n: p.detach().clone().requires_grad_(True)
                 for n, p in block.named_parameters()}
        placed = {n: distribute_tensor(p.detach().clone(), rules.mesh,
                                       rules.placements(specs[n]),
                                       src_data_rank=None).requires_grad_(True)
                  for n, p in block.named_parameters()}

        def run(weights, x, dy):
            x = x.clone().requires_grad_(True)
            m = types.SimpleNamespace(**weights, shared=None)
            y, aux = moe_mod.apply_moe(m, x, cfg)
            loss = (y * dy).sum() + aux
            grads = torch.autograd.grad(loss, [x, *weights.values()])
            return y, aux, grads

        y, aux, grads = run(plain, x, dy)
        with sharding.constrainer(rules.constrain_fn()):
            xd = distribute_tensor(x, rules.mesh, [Shard(0), Replicate()],
                                   src_data_rank=None)
            yd, auxd, grads_d = run(placed, xd, distribute_tensor(
                dy, rules.mesh, [Shard(0), Replicate()], src_data_rank=None))
        out[name] = {
            "y_err": float((full(yd) - y).abs().max()),
            "aux_err": abs(float(full(auxd)) - float(aux)),
            "grad_rel": max(float((full(gd) - g).norm() / g.norm())
                            for g, gd in zip(grads, grads_d)),
            "y_dtensor": isinstance(yd, DTensor)}
    out["ok"] = all(r["y_dtensor"] for r in out.values())
    return out


def check_engines_with_rules(tmp):
    """``ServeEngine(rules=)`` at (2, 2) and (1, 4) against the plain
    engine, qwen2 and dbrx smoke: the same greedy tokens.  At "model" 2
    each shard's 2 query heads read one KV head, at 4 two shards share
    one."""
    prompts = ([1, 2, 3], [5, 6, 7, 8, 9, 10, 11, 12, 13], [4])
    out = {}
    for arch in ("qwen2-1.5b", "dbrx-132b"):
        cfg = smoke(arch)
        for mesh in (None, (2, 2), (1, 4)):
            rules = mesh and MeshRules(make_host_mesh(*mesh),
                                       sequence_parallel=False)
            params = api.init_params(cfg, torch.Generator().manual_seed(SEED),
                                     "cpu")
            eng = ServeEngine(cfg, params, slots=2, max_len=32, page_size=8,
                              prefill_chunk=8, rules=rules, device="cpu")
            rs = [eng.submit(p, max_new_tokens=4) for p in prompts]
            eng.run()
            eng.assert_no_leaks()
            key = f"{arch}/{'plain' if mesh is None else mesh}"
            out[key] = [list(r.out_tokens) for r in rs]
            if mesh is not None:
                out[f"{key}/dtensor"] = isinstance(eng.params.embed, DTensor)
    out["ok"] = True
    return out


def check_built_steps(tmp):
    """``build_step`` for a prefill and a decode cell on a (1, 1) mesh:
    last-position logits and one lockstep decode step (cache placed by
    ``cache_specs``) equal the plain steps' bit for bit."""
    cfg = registry.smoke(ARCH)
    rules = MeshRules(make_host_mesh(1, 1))
    out = {}
    prefill = ShapeConfig("p", "prefill", seq_len=64, global_batch=2)
    batch = synthetic_batch(cfg, prefill, seed=BATCH_SEED, step=0)
    del batch["labels"]
    params = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    want = steps.prefill_step(params, batch, cfg, device="cpu")
    got = steps.build_step(cfg, prefill, rules).fn(params, batch)
    out["prefill_equal"] = torch.equal(full(got), want)

    decode = ShapeConfig("d", "decode", seq_len=32, global_batch=2)
    plain = api.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    built = steps.build_step(cfg, decode, rules)
    tokens = torch.tensor([[3], [7]], dtype=torch.int32)
    cache, ref_cache = (api.init_cache(cfg, 2, 32, device="cpu")
                        for _ in range(2))
    equal = []
    for _ in range(3):
        logits, cache = built.fn(params, tokens, cache)
        ref, ref_cache = steps.serve_step(plain, tokens, ref_cache, cfg)
        equal.append(torch.equal(full(logits), ref))
        tokens = ref.argmax(-1, keepdim=True).to(torch.int32)
    out["decode_equal"] = equal
    out["cache_dtensor"] = isinstance(cache["layers"][0]["k"], DTensor)
    out["ok"] = (out["prefill_equal"] and all(equal)
                 and out["cache_dtensor"])
    return out


def check_dryrun_traces(tmp):
    """dbrx, mamba2 and whisper (the families group's cuts): one sharded
    training step at (2, 2) run for real under ``dryrun.trace_step``'s
    counters, for the test to hold rank 0's per-rank FLOPs and
    collectives against the same step traced on meta over a fake world
    (tests/torch_dryrun_checks.py).  The batch takes the dtypes of
    ``input_specs``, as the traced step's does."""
    from repro_torch.launch import dryrun
    rules = MeshRules(make_host_mesh(2, 2), sequence_parallel=False)
    out = {}
    for name in ("dbrx", "mamba2", "whisper"):
        arch, changes = FAMILIES[name]
        cfg = smoke(arch, **changes)
        built = steps.build_train_step(cfg, SHAPE, rules)
        state = reshard_state(plain_state(cfg), rules)
        specs = api.input_specs(cfg, SHAPE)
        batch = {k: torch.as_tensor(v).to(specs[k].dtype)
                 for k, v in batch_fn(cfg)(0).items()}
        rec = dryrun.trace_step(built, (state, batch))
        out[name] = {k: rec[k] for k in ("flops", "collectives",
                                         "collective_counts",
                                         "kernel_calls")}
    out["ok"] = True
    return out


def check_attention_layouts(tmp):
    """Blocked attention and the head merge (``layers._flat_heads`` and
    the output product) on DTensors at (1, 4) under the rules, 6 query
    heads over "model" 4, forward and gradients against the plain call:
    at B 2 the heads are padded to 8 (``layers._head_padding``), at B 4
    the batch is split over "model" instead."""
    from repro_torch.models import layers
    rules = MeshRules(make_host_mesh(1, 4), sequence_parallel=False)
    mesh, out = rules.mesh, {}
    h, hkv, s, d = 6, 2, 64, 16
    for name, b in (("padded_heads", 2), ("batch_over_model", 4)):
        gen = torch.Generator().manual_seed(b)
        ins = [torch.randn(b, n, s, d, generator=gen)
               for n in (h, hkv, hkv)] + [torch.randn(h * d, 32,
                                                      generator=gen)]
        dy = torch.randn(b * s, 32, generator=gen)

        def run(*ins):
            q, k, v, wo = (t.detach().requires_grad_(True) for t in ins)
            y = layers.blocked_attention(q, k, v, causal=True, q_chunk=16,
                                         k_chunk=32)
            o = layers._flat_heads(y) @ wo
            return o, torch.autograd.grad(o, (q, k, v, wo),
                                          sharding.replicated(dy, o))

        want, grads = run(*ins)
        rep = [Replicate(), Replicate()]
        with sharding.constrainer(rules.constrain_fn()):
            got, grads_d = run(*(distribute_tensor(t, mesh, rep,
                                                   src_data_rank=None)
                                 for t in ins))
        out[name] = {
            "pad": layers._head_padding(distribute_tensor(
                ins[0], mesh, rep, src_data_rank=None)),
            "err": float((full(got) - want).abs().max()),
            "scale": float(want.abs().max()),
            "grad_rel": max(float((full(g) - w).norm() / w.norm())
                            for g, w in zip(grads_d, grads))}
    out["ok"] = True
    return out


# -- sequence parallelism ---------------------------------------------------

STRICT_VIEW_ERROR = ("Attempted to flatten multiple dimensions, with "
                     "dimension {} being sharded. ")


class StrictViews:
    """torch 2.11's rule for DTensor views, enforced on any torch.  In
    2.11, ``torch/distributed/tensor/_ops/_view_ops.py``'s
    ``propagate_shape_and_sharding`` reads, for each ``Flatten`` of a
    view's rule::

        for i, dim in enumerate(cmd.input_dims):
            ...
            input_sharded = shard_mesh_dim is not None
            if i > 0:
                can_shard_dim = False
                if strict_view and input_sharded:
                    raise RuntimeError(
                        f"Attempted to flatten multiple dimensions, with
                        dimension {dim.input_dim} being sharded. ",
                        "It cannot be performed without redistribution,
                        which is disallowed by the current operator.")

    and ``aten.view`` and ``aten._unsafe_view`` (which ``reshape`` and
    ``matmul``'s folding decompose to) are registered with
    ``strict_view=True``: a view may merge a sharded dim only as the first
    of the dims it merges.  Later versions view such a merge as a
    ``_StridedShard``.  :meth:`install` wraps the running torch's
    ``propagate_shape_and_sharding`` so that it raises 2.11's error
    wherever 2.11 would, and records each refusal and the count of strict
    views it checked."""

    def __init__(self):
        self.refused: list[str] = []
        self.checked = 0

    def install(self) -> None:
        from torch.distributed.tensor._ops import _view_ops
        real = _view_ops.propagate_shape_and_sharding

        def flattens(cmd):
            if isinstance(cmd, _view_ops.Flatten):
                yield cmd
            for inp in cmd.inputs():
                yield from flattens(inp)

        def propagate(placements, shape, rule, mesh_sizes, strict_view=False):
            if strict_view:
                self.checked += 1
                for fl in (f for cmd in rule for f in flattens(cmd)):
                    for dim in fl.input_dims[1:]:
                        if any(isinstance(p, Shard) and p.dim == dim.input_dim
                               for p in placements):
                            self.refused.append(
                                f"{tuple(shape)} {tuple(placements)} "
                                f"{rule}")
                            raise RuntimeError(
                                STRICT_VIEW_ERROR.format(dim.input_dim),
                                "It cannot be performed without "
                                "redistribution, which is disallowed by the "
                                "current operator.")
            return real(placements, shape, rule, mesh_sizes, strict_view)

        _view_ops.propagate_shape_and_sharding = propagate
        DTensor._op_dispatcher.sharding_propagator \
            .propagate_op_sharding.cache_clear()


_STRICT = StrictViews()


def strict_views() -> None:
    """The ``sequence_parallel_families`` group's set-up on each rank,
    before its first DTensor op (no sharding decision is cached yet)."""
    _STRICT.install()


class Boundaries:
    """Records the residual stream's placements at every block boundary
    (the input and the output of ``lm._apply_block``, ``encdec._enc_block``
    and ``encdec._dec_block``, the recomputes included) while installed."""

    SITES = ((None, "_apply_block"), ("encdec", "_enc_block"),
             ("encdec", "_dec_block"))

    def __init__(self):
        self.seen: list[tuple] = []

    def __enter__(self):
        from repro_torch.models import lm
        self._saved = []
        for mod, name in self.SITES:
            owner = encdec if mod else lm
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def _wrap(self, fn):
        def block(p, x, *args, **kwargs):
            out = fn(p, x, *args, **kwargs)
            y = out[0] if isinstance(out, tuple) else out
            self.seen += [(tuple(t.shape), t.placements[m], t.device_mesh
                           .size(m)) for t in (x, y) if isinstance(t, DTensor)
                          for m in [t.device_mesh.mesh_dim_names
                                    .index("model")]]
            return out
        return block

    def off_sequence(self) -> list[str]:
        """Boundaries (on a mesh) where the stream is not ``Shard(1)``
        over ``model`` though ``model`` divides its sequence."""
        return [f"{shape} {pl}" for shape, pl, m in self.seen
                if shape[1] % m == 0 and pl != Shard(1)]

    def summary(self) -> dict:
        return {"boundaries": len(self.seen),
                "off_sequence": self.off_sequence()[:8]}


def sp_steps(cfg, mesh=(2, 2), bf16=True) -> dict:
    """With the rules' default sequence parallelism at ``mesh``: a
    bfloat16 ``build_train_step`` step's loss (for the test to hold
    against the reference's), the float32 step against the unsharded
    ``train_step`` and the float32 ``build_step`` prefill against
    ``prefill_step``, recording the stream's layout at every block
    boundary of the sharded runs."""
    out = {"mesh": list(mesh)}
    with Boundaries() as seen:
        if bf16:
            _, _, built, state = tiny_setup(*mesh, sequence_parallel=True,
                                            cfg=cfg)
            out["loss"] = float(built.fn(state, batch_fn(cfg)(0))[1]["loss"])
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        out.update(f32_step_vs_plain(sequence_parallel=True, cfg=cfg32,
                                     mesh=mesh))
        rules = MeshRules(make_host_mesh(*mesh))
        assert rules.sequence_parallel
        out.update(prefill_vs_plain(cfg32, rules))
        if cfg.family == "encdec":
            out.update(cross_vs_plain(cfg32, rules))
    out.update(seen.summary(), moe=cfg.n_experts > 0)
    out["ok"] = out["ok"] and bool(seen.seen) and not seen.off_sequence()
    return out


def cross_vs_plain(cfg32, rules) -> dict:
    """``encdec.encode`` and ``precompute_cross`` (float32) on parameters
    and frames placed under ``rules`` against the plain calls: the largest
    cross K/V difference and the largest plain value."""
    def params():
        return api.init_params(cfg32, torch.Generator().manual_seed(SEED),
                               "cpu")

    frames = torch.randn(SHAPE.global_batch, SHAPE.seq_len, cfg32.d_model,
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        plain = params()
        want = encdec.precompute_cross(
            plain, encdec.encode(plain, frames, cfg32), cfg32)
        placed = reshard(params(), rules, rules.param_specs(plain))
        x = reshard(frames, rules,
                    rules.batch_specs({"frames": frames})["frames"])
        with sharding.constrainer(rules.constrain_fn()):
            got = encdec.precompute_cross(
                placed, encdec.encode(placed, x, cfg32), cfg32)
    return {"cross_err": max(float((full(g) - w).abs().max())
                             for g, w in zip(got, want)),
            "cross_scale": max(float(w.abs().max()) for w in want)}


def _sp_family_check(name):
    def check(tmp):
        return sp_steps(smoke(FAMILIES[name][0], **FAMILIES[name][1]))

    check.__name__ = f"check_sp_family_{name}"
    return check


def check_sp_qwen2_1x4(tmp):
    """qwen2 with the sequence sharded 4 ways over "model" (1, 4)."""
    return sp_steps(smoke(), mesh=(1, 4))


def apply_moe_f32_experts(p, x, cfg):
    """``models.moe.apply_moe`` with the expert inputs and the combine
    weights kept in the model's dtype (float32 here) where the port, as
    the reference, rounds them to bfloat16; the rest is the same code."""
    F = torch.nn.functional
    x = sharding.whole_sequence(x)
    orig_shape = x.shape
    d = orig_shape[-1]
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    gs = min(cfg.moe_group_size, n_tok)
    g, e = n_tok // gs, cfg.n_experts
    cap = moe_mod.moe_capacity(cfg, gs)
    route = lambda t, lg: moe_mod._route_dispatch(t, lg, cfg=cfg, gs=gs)
    combine = moe_mod._combine
    if isinstance(x, DTensor):
        route, combine = moe_mod._regions(x, e, g, cap, d, route, combine)
    logits = tokens.float() @ p.router
    xe, slot, top_w, probs, first = route(tokens, logits)      # no rounding
    xe = sharding.constrain(xe, "expert_tokens")
    xe = xe.reshape(e, g * cap, d).to(p.wi_gate.dtype)
    h = F.silu(torch.bmm(xe, p.wi_gate)) * torch.bmm(xe, p.wi_up)
    ye = sharding.constrain(torch.bmm(h, p.wo).reshape(e, g, cap, d),
                            "expert_tokens")
    y = combine(ye, slot, top_w)                                # no rounding
    if p.shared is not None:
        y = y + moe_mod.layers.apply_mlp(p.shared, tokens).to(y.dtype)
    aux = e * torch.sum(first.mean(dim=0) * probs.mean(dim=0))
    return y.reshape(orig_shape).to(x.dtype), aux


def check_moe_moments_f32_experts(tmp):
    """dbrx and jamba: the float32 sharded step against the unsharded one
    with :func:`apply_moe_f32_experts` in both, sequence parallelism on
    and off, with the configs' bfloat16 AdamW moments and with float32
    ones.  Two roundings move the MoE archs' moments (held to 2**-8 in
    relative norm): the expert inputs' to bfloat16, and the moments' own
    (a one-ulp flip of a bfloat16 moment is 2**-8 of it).  Without both
    they fall to the dense archs' level."""
    saved = moe_mod.apply_moe
    moe_mod.apply_moe = apply_moe_f32_experts
    out = {}
    try:
        for name in ("dbrx", "jamba"):
            for moments in ("bfloat16", "float32"):
                cfg = smoke(FAMILIES[name][0], **FAMILIES[name][1],
                            dtype="float32", adam_dtype=moments)
                for sp in (True, False):
                    r = f32_step_vs_plain(sequence_parallel=sp, cfg=cfg)
                    out[f"{name}/sp_{'on' if sp else 'off'}/{moments}"] = {
                        k: r[k] for k in ("moment_max_rel_norm", "f32_loss",
                                          "f32_plain_loss", "ok")}
    finally:
        moe_mod.apply_moe = saved
    out["ok"] = all(r["ok"] for r in out.values())
    return out


def check_strict_views(tmp):
    """The guard, the group's first check: torch 2.11's view rule
    (:class:`StrictViews`, in force over the whole group) refuses a
    flatten of a sequence-sharded [B, S, D], and qwen2's float32
    sequence-parallel step and prefill at (2, 2) run under it with no
    refusal."""
    mesh = make_host_mesh(2, 2)
    x = distribute_tensor(torch.zeros(8, 64, 16), mesh, [Shard(0), Shard(1)],
                          src_data_rank=None)
    before = list(_STRICT.refused)
    try:
        x.reshape(8 * 64, 16)
        probe = "not refused"
    except RuntimeError as e:
        probe = str(e)
    del _STRICT.refused[len(before):]
    cfg32 = smoke(dtype="float32")
    step = f32_step_vs_plain(sequence_parallel=True, cfg=cfg32)
    out = {"probe": probe, "checked": _STRICT.checked,
           "refused": _STRICT.refused[:8], **prefill_vs_plain(
               cfg32, MeshRules(make_host_mesh(2, 2))),
           **{k: step[k] for k in ("f32_loss", "f32_plain_loss")}}
    out["ok"] = (STRICT_VIEW_ERROR.format(1) in probe
                 and not _STRICT.refused and step["ok"])
    return out


SP_CHECKS = [*map(_sp_family_check, FAMILIES), check_sp_qwen2_1x4]


def _sp_card_check(name, arch, changes, mesh):
    def check(tmp):
        return sp_steps(smoke(arch, **changes), mesh=mesh, bf16=False)

    check.__name__ = f"check_sp_card_{name}"
    return check


# chip_smoke.py's phase 21 on the card machine's own torch (its rule, not
# StrictViews): the float32 steps and prefill of every family at (2, 2)
# and qwen2 at (1, 4)
SP_CARD_CHECKS = [_sp_card_check(name, arch, changes, (2, 2)) for name,
                  (arch, changes) in {"qwen2": (ARCH, {}), **FAMILIES}.items()
                  ] + [_sp_card_check("qwen2_1x4", ARCH, {}, (1, 4))]


# name: (world size, checks), one subprocess each
GROUPS = {"mesh": (4, [check_sharded_train_step, check_checkpoint_roundtrip,
                       check_crash_resume_bitwise, check_elastic_reshard,
                       check_reshard_roundtrip,
                       check_paged_read_model_sharded_heads]),
          "sequence_parallel": (4, [check_sequence_parallel_train_step]),
          "steps": (1, [check_engine_under_mesh, check_built_steps]),
          "families": (4, [*map(_family_check, FAMILIES),
                           check_moe_groups_over_data,
                           check_engines_with_rules]),
          "dryrun": (4, [check_dryrun_traces, check_attention_layouts]),
          "sequence_parallel_families": (
              4, [check_strict_views, *SP_CHECKS,
                  check_moe_moments_f32_experts], strict_views),
          "sequence_parallel_card": (4, SP_CARD_CHECKS)}


def _rank(rank: int, group: str, store_path: str, out: str) -> None:
    world, checks, *setup = GROUPS[group]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    for fn in setup:
        fn()
    results = {}
    tmp = pathlib.Path(out).parent
    try:
        for check in checks:
            name = check.__name__[len("check_"):]
            t0 = time.monotonic()
            try:
                results[name] = check(tmp / name)
                results[name]["seconds"] = time.monotonic() - t0
            except Exception:
                results[name] = {"ok": False,
                                 "error": traceback.format_exc()[-3000:]}
                raise
    finally:
        if rank == 0:
            pathlib.Path(out).write_text(json.dumps(results))
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--group", choices=sorted(GROUPS), required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    world = GROUPS[args.group][0]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(args.out)) as d:
        mp.spawn(_rank, args=(args.group, os.path.join(d, "store"),
                              args.out), nprocs=world)


if __name__ == "__main__":
    main()
