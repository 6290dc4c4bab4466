"""The sharding layer's steps on a one-rank gloo mesh (1, 1): the twin of
tests/test_serve_engine.py::test_engine_under_host_mesh (the engine with
rules: DTensor params and a replicated cache, the same greedy tokens as
without), and ``build_step`` for a prefill and a decode cell against the
plain steps, bit for bit; and on 4 ranks (2, 2) a float32 train step with
the sequence sharded over "model" against the unsharded step, to the
tolerances of tests/test_torch_host_mesh.py
(tests/torch_host_mesh_checks.py, groups ``steps`` and
``sequence_parallel``).
"""
import pytest

from test_torch_host_mesh import check_f32_step, result, run_checks


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return run_checks("steps", tmp_path_factory.mktemp("one"))


@pytest.fixture(scope="module")
def sequence_parallel(tmp_path_factory):
    return run_checks("sequence_parallel", tmp_path_factory.mktemp("sp"))


def test_engine_under_host_mesh(one):
    r = result(one, "engine_under_mesh")
    assert r["mesh_dtensor"] and not r["plain_dtensor"]
    assert r["mesh"] == r["plain"] and all(len(t) == 4 for t in r["mesh"])


def test_built_prefill_and_decode_steps_under_a_mesh(one):
    r = result(one, "built_steps")
    assert r["prefill_equal"] and r["decode_equal"] == [True] * 3
    assert r["cache_dtensor"]


def test_sequence_parallel_train_step_matches_the_unsharded_step(
        sequence_parallel):
    check_f32_step(result(sequence_parallel, "sequence_parallel_train_step"))
