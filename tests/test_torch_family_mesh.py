"""Every model family of the port under ``MeshRules`` on a mesh of CPU
ranks: dbrx (MoE), mamba2 (SSM), jamba (hybrid, cut to its first 4
layers and one microbatch) and whisper (encoder-decoder) smoke configs.

tests/torch_host_mesh_checks.py runs the ``families`` group on 4 gloo
ranks in one subprocess shared by the tests of this file: at (2, 2) a
sharded training step per family, ``build_step`` prefill and 3 lockstep
decode steps, ``apply_moe`` with groups that divide over "data" and a
group that does not; ``ServeEngine(rules=)`` at (2, 2) and (1, 4) for
qwen2 and dbrx.

Tolerances: the bfloat16 sharded loss within 5e-3 relative of the
reference's single-device ``api.train_loss`` on the same (carried)
weights, and the float32 sharded step against the port's unsharded one
as tests/test_torch_host_mesh.py holds them.  Float32 prefill and decode
logits within 1e-5 of the largest plain logit (summation order: a
sharded contraction adds its partial sums in another order).  An MoE
arch rounds its expert inputs to bfloat16, in float32 too, as the
reference does, and a difference in the last float32 bit before the
rounding can move one by a bfloat16 step: there the logits are held
within 2**-8 of the largest, and each AdamW moment within 2**-8 in
relative norm (the worst leaves are the router's and the MoE block's
norm).  ``apply_moe``: y and the aux loss within 1e-5, every gradient
within 1e-5 in relative norm.  Greedy tokens are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import api as jax_api
from repro_torch.checkpoint import convert
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import api
from test_torch_host_mesh import check_f32_step, result, run_checks
import torch_host_mesh_checks as checks

RUN_TIMEOUT_S = 300
F32_TOL = 1e-5
MOE_TOL = 2.0 ** -8


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return run_checks("families", tmp_path_factory.mktemp("families"),
                      timeout=RUN_TIMEOUT_S)


def _reference_loss(arch: str, changes: dict) -> float:
    """The reference's single-device loss on the port's seed-0 smoke
    weights of ``arch`` (with the checks' cuts) and the checks' first
    batch."""
    cfg = checks.smoke(arch, **changes)
    params = api.init_params(cfg, torch.Generator().manual_seed(checks.SEED),
                             "cpu")
    jcfg = dataclasses.replace(jax_registry.smoke(arch), **changes)
    like = jax_api.abstract_params(jcfg)
    jparams = jax.tree.map(lambda a, l: jnp.asarray(a, l.dtype),
                           convert.params_to_numpy(params, cfg), like)
    batch = synthetic_batch(cfg, checks.SHAPE, seed=checks.BATCH_SEED, step=0)
    return float(jax_api.train_loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))


@pytest.mark.parametrize("name", list(checks.FAMILIES))
def test_family_train_step_matches_the_reference_and_the_plain_step(
        families, name):
    r = result(families, f"family_{name}")
    ref = _reference_loss(*checks.FAMILIES[name])
    assert abs(r["loss"] - ref) / abs(ref) < 5e-3, (r["loss"], ref)
    check_f32_step(r, moment_tol=MOE_TOL if r["moe"] else 1e-4)


@pytest.mark.parametrize("name", list(checks.FAMILIES))
def test_family_prefill_and_decode_steps_match_the_plain_steps(families,
                                                               name):
    r = result(families, f"family_{name}")
    assert r["cache_dtensor"], r
    tol = MOE_TOL if r["moe"] else F32_TOL
    assert r["prefill_err"] <= tol * r["prefill_scale"], r
    assert len(r["decode_errs"]) == 3
    assert max(r["decode_errs"]) <= tol * r["decode_scale"], r


@pytest.mark.parametrize("case", ["groups_divide", "group_replicated"])
def test_moe_groups_over_data_match_the_plain_call(families, case):
    r = result(families, "moe_groups_over_data")[case]
    assert r["y_dtensor"], r
    assert r["y_err"] <= F32_TOL and r["aux_err"] <= F32_TOL, r
    assert r["grad_rel"] <= F32_TOL, r


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "dbrx-132b"])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_engine_with_rules_gives_the_plain_engines_tokens(families, arch,
                                                          mesh):
    r = result(families, "engines_with_rules")
    assert r[f"{arch}/{mesh}/dtensor"]
    assert r[f"{arch}/{mesh}"] == r[f"{arch}/plain"]
    assert all(len(t) == 4 for t in r[f"{arch}/plain"])
