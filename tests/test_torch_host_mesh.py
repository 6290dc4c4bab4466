"""The port's sharding layer on a mesh of CPU ranks: the twins of
tests/test_distributed.py's host-mesh checks (sharded train step, sharded
checkpoint round trip, crash -> resume, elastic reshard, reshard round
trip), and the paged read with query heads sharded over a "model" axis
of 2 and of 4, bit for bit the unsharded read.

tests/torch_host_mesh_checks.py runs the checks on 4 gloo ranks (mesh
(2, 2), qwen2 smoke at seq 64 x batch 8, ``sequence_parallel=False``, as
the reference's checks) in one subprocess shared by the tests of this
file; tests/test_torch_mesh_steps.py runs the one-rank checks.

Tolerances: the sharded loss within 5e-3 relative of the reference's
single-device ``api.train_loss`` on the same (carried) weights, the
reference's own bound.  In float32 the sharded step against the port's
unsharded ``train_step`` from the same state: loss and grad norm to 1e-5
relative (summation order), each AdamW moment to 1e-4 in relative norm
(tests/test_torch_train.py's float32 bound) and each parameter to 2 lr,
the most AdamW's normalised update can move on a float32 gradient
difference where sqrt(v) is near eps.  The rest is bit for bit.
"""
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import api as jax_api
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import api

SCRIPT = pathlib.Path(__file__).parent / "torch_host_mesh_checks.py"
sys.path.insert(0, str(SCRIPT.parent))
import torch_host_mesh_checks as checks  # noqa: E402

RUN_TIMEOUT_S = 300


def run_checks(group: str, tmp: pathlib.Path,
               timeout: float = RUN_TIMEOUT_S) -> dict:
    out = tmp / "result.json"
    proc = subprocess.run(
        [sys.executable, str(SCRIPT), "--group", group, "--out", str(out)],
        capture_output=True, text=True, timeout=timeout)
    results = json.loads(out.read_text()) if out.exists() else {}
    if proc.returncode != 0 and not results:
        pytest.fail(f"{group}: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    return results


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_checks("mesh", tmp_path_factory.mktemp("four"))


def result(results: dict, name: str) -> dict:
    assert name in results, f"{name} did not run: {sorted(results)}"
    r = results[name]
    assert "error" not in r, r["error"]
    return r


def _reference_loss() -> float:
    """The reference's single-device loss on the port's seed-0 smoke
    weights and the checks' first batch."""
    cfg = registry.smoke(checks.ARCH)
    params = api.init_params(cfg, torch.Generator().manual_seed(checks.SEED),
                             "cpu")
    jcfg = jax_registry.smoke(checks.ARCH)
    like = jax_api.abstract_params(jcfg)
    jparams = jax.tree.map(lambda a, l: jnp.asarray(a, l.dtype),
                           convert.params_to_numpy(params, cfg), like)
    batch = synthetic_batch(cfg, checks.SHAPE, seed=checks.BATCH_SEED, step=0)
    return float(jax_api.train_loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))


def check_f32_step(r: dict, moment_tol: float = 1e-4) -> None:
    """The float32 sharded step against the port's unsharded one."""
    assert r["placed"] and r["step_equal"]
    for key in ("loss", "grad_norm"):
        got, want = r[f"f32_{key}"], r[f"f32_plain_{key}"]
        assert abs(got - want) <= 1e-5 * abs(want), (key, got, want)
    assert r["moment_max_rel_norm"] <= moment_tol, r
    assert r["param_max_abs"] <= 2 * r["lr"], r


def test_sharded_train_step_matches_single_device(four):
    r = result(four, "sharded_train_step")
    ref = _reference_loss()
    assert abs(r["loss"] - ref) / abs(ref) < 5e-3, (r["loss"], ref)
    check_f32_step(r)


@pytest.mark.parametrize("name", ["checkpoint_roundtrip",
                                  "crash_resume_bitwise", "elastic_reshard",
                                  "reshard_roundtrip",
                                  "paged_read_model_sharded_heads"])
def test_host_mesh_check(four, name):
    r = result(four, name)
    assert r["ok"], r


def test_crash_resume_restarts_from_a_sharded_checkpoint(four):
    r = result(four, "crash_resume_bitwise")
    assert r["resumed_from"] == 3 and r["last_loss"] == r["ref_last_loss"]
