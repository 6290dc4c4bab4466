"""Sequence parallelism, the rules' default, for every model family under
torch 2.11's rule for DTensor views: dbrx (MoE), mamba2 (SSM), jamba
(hybrid, cut to its first 4 layers and one microbatch) and whisper
(encoder-decoder) smoke configs at (2, 2), and qwen2 with the sequence
sharded 4 ways at (1, 4).

tests/torch_host_mesh_checks.py runs the ``sequence_parallel_families``
group on 4 gloo ranks in one subprocess shared by the tests of this file,
with ``StrictViews`` installed on every rank before its first DTensor op:
2.11 refuses a view that merges a sharded dim into a dim before it
("Attempted to flatten multiple dimensions, with dimension 1 being
sharded"), which later versions view as a ``_StridedShard``.  The guard
test holds that rule's probe and qwen2's step; on a port that flattens a
sequence-sharded [B, S, D] for a product, every check of the group is
refused.

Tolerances are tests/test_torch_family_mesh.py's: the bfloat16 sharded
loss within 5e-3 relative of the reference's single-device
``api.train_loss``; the float32 sharded step against the port's unsharded
one as tests/test_torch_host_mesh.py holds it (MoE archs' moments to
2**-8); float32 prefill logits within 1e-5 of the largest plain logit
(MoE 2**-8).  The residual stream is ``Shard(1)`` over "model" at every
block boundary of the sharded runs.  The MoE archs' moment gap is shown
by ``check_moe_moments_f32_experts``: with the expert inputs kept in
float32 and float32 AdamW moments, both held to the dense archs' 1e-4.
"""
import pytest

from test_torch_family_mesh import F32_TOL, MOE_TOL, _reference_loss
from test_torch_host_mesh import check_f32_step, result, run_checks
import torch_host_mesh_checks as checks

RUN_TIMEOUT_S = 300
CASES = {**{name: (f"sp_family_{name}", checks.FAMILIES[name])
            for name in checks.FAMILIES},
         "qwen2_1x4": ("sp_qwen2_1x4", (checks.ARCH, {}))}


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    return run_checks("sequence_parallel_families",
                      tmp_path_factory.mktemp("sp_families"),
                      timeout=RUN_TIMEOUT_S)


def test_strict_views_refuse_a_sequence_sharded_flatten_and_not_the_port(sp):
    r = result(sp, "strict_views")
    assert checks.STRICT_VIEW_ERROR.format(1) in r["probe"], r["probe"]
    assert r["refused"] == [] and r["checked"] > 0, r
    got, want = r["f32_loss"], r["f32_plain_loss"]
    assert abs(got - want) <= 1e-5 * abs(want), r
    assert r["prefill_err"] <= F32_TOL * r["prefill_scale"], r


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_train_step_matches_the_reference_and_the_plain_step(
        sp, case):
    name, (arch, changes) = CASES[case]
    r = result(sp, name)
    ref = _reference_loss(arch, changes)
    assert abs(r["loss"] - ref) / abs(ref) < 5e-3, (r["loss"], ref)
    check_f32_step(r, moment_tol=MOE_TOL if r["moe"] else 1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_prefill_matches_the_plain_prefill(sp, case):
    r = result(sp, CASES[case][0])
    tol = MOE_TOL if r["moe"] else F32_TOL
    assert r["prefill_err"] <= tol * r["prefill_scale"], r


def test_encoder_output_and_cross_kv_under_sequence_parallelism(sp):
    r = result(sp, "sp_family_whisper")
    assert r["cross_err"] <= F32_TOL * r["cross_scale"], r


@pytest.mark.parametrize("case", list(CASES))
def test_stream_is_sequence_sharded_at_every_block_boundary(sp, case):
    r = result(sp, CASES[case][0])
    assert r["boundaries"] > 0 and r["off_sequence"] == [], r


@pytest.mark.parametrize("sp_on", ["on", "off"])
@pytest.mark.parametrize("arch", ["dbrx", "jamba"])
def test_moe_moments_fall_to_the_dense_bound_without_bf16_roundings(
        sp, arch, sp_on):
    r = result(sp, "moe_moments_f32_experts")
    exact = r[f"{arch}/sp_{sp_on}/float32"]
    assert exact["moment_max_rel_norm"] <= 1e-4, exact
    assert r[f"{arch}/sp_{sp_on}/bfloat16"]["moment_max_rel_norm"] <= MOE_TOL
