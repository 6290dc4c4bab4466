"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
from __future__ import annotations

import ast
import json
import re

import pytest
from perfbench_tiny import ROOT, tiny_tree

from perfbench import check, manifest

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan"
                   r"|_dim$|_rank$|experts_per_tok|top_k|d_model|d_ff"
                   r"|ffn_hidden)", re.I)
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_and_units():
    assert set(MAN) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            extra = set(e) - KEYS[group]
            assert extra <= ({"workloads"} if group in ("end_to_end",
                                                         "per_layer")
                             else set()), (group, e["name"], extra)
            assert KEYS[group] <= set(e), (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) \
        == len(MAN["workloads"])


def test_bounds_and_run_seconds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    full = (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert full <= 43200
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith(("_roofline", "_roofline.batch",
                               "_roofline.chat")) or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_paths_and_command():
    assert MAN["paths"] == ["perfbench"]
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (ROOT / MAN["command"][1]).is_file()
    assert MAN["command"][1].startswith("perfbench/")


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_and_metrics(cell):
    c = manifest.cell(ROOT, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, cell
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"], m["moves"])
        assert callable(manifest.reader(ROOT, "per_layer", m["name"]))
    for m in c.end_to_end:
        assert callable(manifest.reader(ROOT, "end_to_end", m["name"]))
    compared = [n for n in check.COMPARED if n in c.limits]
    assert compared and all(c.limits[n]["limit"] > 0 for n in compared)
    assert c.limits["min_tokens"] >= 100
    assert c.traffic["engine"]["max_len"] >= (c.traffic["prompt_len"][1]
                                              + c.traffic["out_len"][1])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_limit_lies_between_its_readings(cell):
    """A limit stands above the program's largest sound reading and below
    the control's least, with the more room above the program's."""
    limits = manifest.cell(ROOT, cell).limits
    for name in check.COMPARED:
        if name in limits:
            lo, lim, hi = (limits[name][k] for k in ("lower", "limit",
                                                      "upper"))
            assert lo < lim < hi and hi >= 3 * lo, (name, lo, lim, hi)
            assert lim / lo >= hi / lim * 0.9, (name, lo, lim, hi)


def test_every_layer_metric_lists_cells_that_report_what_it_moves():
    for m in MAN["per_layer"]:
        for cell in m.get("workloads", []):
            moves = {e["name"] for e in manifest.end_to_end_of(MAN, cell)}
            assert m["moves"] in moves, (m["name"], cell)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_file_states_what_runs(conf):
    """The arch block both sides read agrees with the published keys; the
    manifest's ``reduced`` lists exactly the file's cuts, and none is a
    width."""
    data = json.loads((ROOT / conf["file"]).read_text())
    bench = data["perfbench"]
    assert conf["source"] in bench["source"]
    assert sorted(bench["reduced"]) == sorted(conf["reduced"])
    assert not any(WIDTH.search(k) for k in conf["reduced"])
    arch = bench["arch"]
    for field, path in bench["arch_keys"].items():
        v = data
        for part in path.split("."):
            v = v[part]
        assert arch[field] == v, (field, path)
    assert arch["d_head"] * arch["n_heads"] == arch["d_model"]
    assert bench["dtype"] == data["torch_dtype"] == "bfloat16"
    for key, published in bench["reduced"].items():
        assert data[key] != published
    assert bench["reference"].startswith("perfbench/reference/")
    assert bench["adapter"].startswith("perfbench/adapters/")
    assert (ROOT / bench["reference"]).is_file()
    assert (ROOT / bench["adapter"]).is_file()
    if arch["n_experts"]:
        # dropless routing, as published: each expert can take the group
        assert arch["capacity_factor"] == arch["n_experts"] / arch["top_k"]


def test_metric_files_are_small_readers():
    for kind in ("end_to_end", "per_layer"):
        for f in (ROOT / "perfbench" / kind).glob("*.py"):
            tree = ast.parse(f.read_text())
            fns = [n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef)]
            assert "read" in fns, f


@pytest.mark.parametrize("key", ["adapter", "reference"])
@pytest.mark.parametrize("value", [None, "perfbench/program.py",
                                   "{dir}absent.py"],
                         ids=["missing", "elsewhere", "absent"])
def test_a_configuration_without_its_modules_is_refused(tmp_path, key,
                                                         value):
    """No default module: a configuration that names no adapter or
    reference, or one outside its directory or not there, is an error."""
    tree = tiny_tree(tmp_path)
    path = tree / "perfbench/configs/tiny-moe.json"
    data = json.loads(path.read_text())
    if value is None:
        del data["perfbench"][key]
    else:
        data["perfbench"][key] = value.format(
            dir=manifest.MODULE_DIRS[key])
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match=f"perfbench.{key}"):
        manifest.cell(tree, "tiny-moe.tclosed")
