"""The port's host-mesh checks: the twins of tests/host_mesh_checks.py on
ranks of a gloo group (one CPU process a rank) instead of host devices.

Run by tests/test_torch_host_mesh.py and tests/test_torch_mesh_steps.py:

    python tests/torch_host_mesh_checks.py --group mesh --out result.json

spawns the group's ranks (4 for ``mesh`` and ``sequence_parallel``, 1 for
``steps``) that meet through a ``FileStore`` next to ``--out`` (no TCP
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
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api, paged_lm  # noqa: E402
from repro_torch.models.types import ShapeConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.elastic import reshard_state  # noqa: E402
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


def tiny_setup(data=2, model=2, seed=SEED, dtype=None,
               sequence_parallel=False):
    cfg = registry.smoke(ARCH)
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


def f32_step_vs_plain(sequence_parallel=False) -> dict:
    """One sharded float32 step against the port's unsharded
    ``train_step`` from the same state: loss, grad norm and every leaf."""
    cfg, _, built, state = tiny_setup(dtype="float32",
                                      sequence_parallel=sequence_parallel)
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


def check_paged_read_refuses_model_sharded_heads(tmp):
    """Query heads sharded over a "model" axis of 4: the paged read must
    raise, not read the wrong kv heads."""
    mesh = make_host_mesh(1, 4)
    q = distribute_tensor(torch.zeros(2, 8, 16), mesh,
                          [Replicate(), Shard(1)], src_data_rank=None)
    pool = torch.zeros(3, 4, 2, 16)
    try:
        paged_lm._paged_read(q, pool, pool,
                             torch.ones(2, 1, dtype=torch.int32),
                             torch.ones(2, dtype=torch.int32))
    except NotImplementedError as e:
        return {"ok": "'model'" in str(e), "error_text": str(e)}
    return {"ok": False}


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


# name: (world size, checks), one subprocess each
GROUPS = {"mesh": (4, [check_sharded_train_step, check_checkpoint_roundtrip,
                       check_crash_resume_bitwise, check_elastic_reshard,
                       check_reshard_roundtrip,
                       check_paged_read_refuses_model_sharded_heads]),
          "sequence_parallel": (4, [check_sequence_parallel_train_step]),
          "steps": (1, [check_engine_under_mesh, check_built_steps])}


def _rank(rank: int, group: str, store_path: str, out: str) -> None:
    world, checks = GROUPS[group]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    results = {}
    tmp = pathlib.Path(out).parent
    try:
        for check in checks:
            name = check.__name__[len("check_"):]
            try:
                results[name] = check(tmp / name)
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
