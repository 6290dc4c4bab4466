"""The port's sharding rules against the reference's, spec for spec.

``repro_torch.sharding.rules.MeshRules`` reads only a mesh's axis names
and sizes, so a stand-in with ``shape`` and ``mesh_dim_names`` serves for
it here, and the reference's ``MeshRules`` runs on a
``jax.sharding.AbstractMesh`` of the same shape.  For all ten registry
archs on the production meshes (16, 16) and (2, 16, 16), a (2, 4) mesh
and the host meshes (2, 2) and (4, 1):

* ``param_specs`` / ``state_specs`` of the abstract parameters and
  optimizer state, each port leaf against the reference leaf it is
  carried to (``checkpoint/convert.py``): the reference's layer stacks
  carry a leading group dim, which the port's per-layer leaves lack, so
  their spec drops its first entry;
* ``batch_specs`` over ``input_specs`` of every SHAPES cell, and
  ``cache_specs`` over ``abstract_cache`` of every decode cell;
* the spec ``constrain`` pins for every kind, at the shapes the models
  give it (the reference's observed through ``with_sharding_constraint``).

Specs compare with trailing ``None`` entries dropped.  Then, in a
subprocess with 8 host devices, each rank's shard under the port's
placements must be the index the reference's ``NamedSharding`` gives that
device (tests/torch_sharding_index_map.py).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jax_registry
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.models.types import SHAPES as JAX_SHAPES
from repro.models.types import cell_supported
from repro.sharding import rules as jax_rules
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models.types import SHAPES
from repro_torch.sharding.rules import MeshRules, P

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "host2x2": ((2, 2), ("data", "model")),
    "host4x1": ((4, 1), ("data", "model")),
}
ARCHS = registry.list_archs()
INDEX_MAP = pathlib.Path(__file__).parent / "torch_sharding_index_map.py"


def _rules(mesh: str, **kw):
    shape, names = MESHES[mesh]
    kw.setdefault("multi_pod", "pod" in names)
    return (MeshRules(types.SimpleNamespace(shape=shape,
                                            mesh_dim_names=names), **kw),
            jax_rules.MeshRules(AbstractMesh(shape, names), **kw))


def _norm(spec) -> tuple:
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _drop_group(spec) -> tuple:
    return _norm(tuple(spec)[1:])


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    return jax_api.abstract_params(jax_registry.get(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return api.abstract_params(registry.get(arch))


def _ref_leaf(tree, path):
    for part in path:
        tree = tree[int(part) if isinstance(tree, (list, tuple)) else part]
    return tree


def _ref_param_spec(ref_specs, name: str, cfg):
    """The reference spec of the leaf that the port's parameter ``name``
    is carried to, with a stack's group dim dropped."""
    parts = name.split(".")
    if parts[0] == "blocks":
        group = ref_specs["groups"][int(parts[1]) % cfg.period]
        return _drop_group(_ref_leaf(group, parts[2:]))
    if parts[0] in ("encoder", "decoder"):
        return _drop_group(_ref_leaf(ref_specs[parts[0]], parts[2:]))
    return _norm(_ref_leaf(ref_specs, parts))


def _check_params(specs, ref_specs, cfg):
    assert specs, cfg.name
    for name, spec in specs.items():
        assert isinstance(spec, P)
        assert _norm(spec) == _ref_param_spec(ref_specs, name, cfg), name
    n_ref = len(jax.tree.leaves(ref_specs, is_leaf=lambda s: isinstance(
        s, JP)))
    per_layer = {n for n in specs if n.split(".")[0] in
                 ("blocks", "encoder", "decoder")}
    assert len(specs) - len(per_layer) <= n_ref


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs(arch, mesh):
    rules, ref = _rules(mesh)
    _check_params(rules.param_specs(_port_params(arch)),
                  ref.param_specs(_jax_params(arch)), registry.get(arch))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs(arch, mesh):
    rules, ref = _rules(mesh)
    cfg = registry.get(arch)
    specs = rules.state_specs(steps.abstract_state(
        cfg, steps.make_optimizer(cfg)))
    jcfg = jax_registry.get(arch)
    ref_specs = ref.state_specs(jax_steps.abstract_state(
        jcfg, jax_steps.make_optimizer(jcfg)))
    assert set(specs) == set(ref_specs) == {"params", "m", "v", "step"}
    for k in ("params", "m", "v"):
        _check_params(specs[k], ref_specs[k], cfg)
    assert _norm(specs["step"]) == _norm(ref_specs["step"]) == ()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs(arch, mesh):
    rules, ref = _rules(mesh)
    cfg, jcfg = registry.get(arch), jax_registry.get(arch)
    n_cache = 0
    for cell, shape in SHAPES.items():
        jshape = JAX_SHAPES[cell]
        got = rules.batch_specs(api.input_specs(cfg, shape))
        want = ref.batch_specs(jax_api.input_specs(jcfg, jshape))
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}, cell
        if shape.kind != "decode" or not cell_supported(jcfg, jshape)[0]:
            continue
        n_cache += 1
        got = rules.cache_specs(api.abstract_cache(cfg, shape),
                                shape.global_batch)
        want = ref.cache_specs(jax_api.abstract_cache(jcfg, jshape),
                               jshape.global_batch)
        assert _norm(got["pos"]) == _norm(want["pos"]) == ()
        if cfg.family == "encdec":
            for k in ("self_k", "self_v", "cross_k", "cross_v"):
                assert _norm(got[k]) == _norm(want[k]), (cell, k)
            continue
        assert len(got["layers"]) == cfg.n_layers
        for i, layer in enumerate(got["layers"]):
            ref_layer = want["layers"][i % cfg.period]
            assert set(layer) == set(ref_layer), (cell, i)
            for k, spec in layer.items():
                assert _norm(spec) == _drop_group(ref_layer[k]), (cell, i, k)
    assert n_cache >= 1


def _kind_shapes():
    """(kind, shape) at the shapes the models give each kind, divisible and
    not by the meshes' axes, and at a rank the kind does not apply to."""
    out = []
    for b in (256, 32, 8, 4, 1, 3):
        for s in (4096, 64, 1, 17):
            out.append(("activations", (b, s, 1536)))
        out += [("logits", (b, 256, 151936)), ("logits", (b, 16, 51865)),
                ("decode_logits", (b, 151936)), ("decode_logits", (b, 100)),
                ("attn_heads", (b, 12, 4096, 128)),
                ("attn_heads", (b, 64, 4096, 128)),
                ("attn_kv_rep", (b, 2, 4096, 128)),
                ("ssd_state", (b, 80, 64, 128)), ("ssd_state", (b, 3, 8, 16)),
                ("ssd_y", (b, 256, 80, 64)), ("ssd_y", (b, 16, 3, 8))]
        for nc in (16, 1):
            out += [("ssd_xs5", (nc, b, 256, 80, 64)),
                    ("ssd_xs5", (nc, b, 16, 3, 8)),
                    ("ssd_xs4", (nc, b, 256, 80)), ("ssd_xs4", (nc, b, 16, 3))]
    for g in (256, 16, 3, 1):
        out.append(("expert_tokens", (16, g, 80, 6144)))
    out += [("activations", (8, 64)), ("logits", (8, 100)),
            ("decode_logits", (8, 1, 100)), ("attn_heads", (8, 64, 16)),
            ("attn_kv_rep", (8, 2, 64)), ("ssd_xs5", (1, 2, 3, 4)),
            ("ssd_state", (2, 3, 4)), ("no_such_kind", (8, 64, 64))]
    return out


@pytest.mark.parametrize("sequence_parallel", [True, False])
@pytest.mark.parametrize("mesh", MESHES)
def test_constraint_specs(mesh, sequence_parallel, monkeypatch):
    rules, ref = _rules(mesh, sequence_parallel=sequence_parallel)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: sharding.spec)
    fn = ref.constrain_fn()
    for kind, shape in _kind_shapes():
        x = jax.ShapeDtypeStruct(shape, jax.numpy.float32)
        want = fn(x, kind)
        got = rules.constraint_spec(shape, kind)
        if want is x:
            assert got is None, (kind, shape, got)
            continue
        assert got is not None and _norm(got) == _norm(want), \
            (kind, shape, got, want)
        rules.placements(got)             # a valid layout on this mesh


def test_placements_shard_multi_axis_dims_pod_major():
    rules, _ = _rules("pod2x16x16")
    from torch.distributed.tensor import Replicate, Shard
    assert rules.placements(P(("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert rules.placements(P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="shards two dims"):
        rules.placements(P("model", "model"))
    with pytest.raises(ValueError, match="mesh-dim order"):
        rules.placements(P(("data", "pod")))


def test_local_shards_match_the_references_device_indices(tmp_path):
    """Each of 8 ranks' shards under the port's placements is the slice the
    reference's NamedSharding gives the same position of the mesh."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = tmp_path / "index_map.json"
    proc = subprocess.run([sys.executable, str(INDEX_MAP), str(out)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(out.read_text())
    assert r["checked"] >= 100 and not r["mismatches"], r
