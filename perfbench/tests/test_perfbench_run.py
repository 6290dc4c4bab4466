"""Whole runs on the CPU at tiny sizes: the harness's look for a card
skipped, everything else as on the card.  A sound run is correct; a run
whose timed path is broken underneath is not; a new configuration,
architecture, traffic mix and metric are found by name; without a card,
or without the program beside it, ``run.py`` prints no result."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from perfbench_tiny import CELLS, MOE, ROOT, one_thread, tiny_tree, write

from perfbench import manifest
from perfbench.run import run_cell
from repro_torch.models import layers, paged_lm

SEED = 2**31 + 777
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0][
    "name"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    with one_thread():
        yield tiny_tree(tmp_path_factory.mktemp("perfbench"))


def run(tree, cell, seconds=3.0):
    return run_cell(tree, cell, SEED, seconds, False, torch.device("cpu"),
                    time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tree, cell):
    r = run(tree, cell)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in manifest.cell(tree, cell).end_to_end}
    assert set(r["metrics"]) == want
    assert r["checks"]["tokens_judged"]["value"] >= 16


def _altered_token(orig):
    def sample(logits, temps, key_data):
        out = orig(logits, temps, key_data)
        return (out + 1) % logits.shape[-1]
    return sample


def _one_slot_altered(orig):
    """Every token that slot 0 decodes altered, the other slots sound."""
    def sample(logits, temps, key_data):
        out = orig(logits, temps, key_data)
        if logits.dim() == 2 and logits.shape[0] > 1:
            out = out.clone()
            out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    return sample


def _unwritten_cache(pool, pid, off, vals, mask):
    """A step that leaves the KV cache as it found it."""


def _half_batch(orig):
    """The paged read left out for every other slot of the batch."""
    def read(q, kp, vp, table, lengths):
        y = orig(q, kp, vp, table, lengths)
        y[1::2] = 0
        return y
    return read


FAULTS = {
    "token_altered": ("_sample", _altered_token),
    "state_unchanged": ("_write_paged", lambda orig: _unwritten_cache),
    "half_batch_left_out": ("_paged_read", _half_batch),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-dense.tclosed", "tiny-moe.topen"])
def test_broken_timed_path_is_not_correct(tree, cell, fault, monkeypatch):
    name, make = FAULTS[fault]
    monkeypatch.setattr(paged_lm, name, make(getattr(paged_lm, name)))
    r = run(tree, cell)
    assert not r["correct"], r["checks"]


def test_one_slot_altered_fails_the_request_mean(tree, tmp_path, monkeypatch):
    """A fault in one slot's stream among sound slots: the largest mean gap
    of one judged request reads it, whatever the others read.  Every
    request is greedy, every finished one judged and read alone, however
    short, so that the slot's requests are read whatever the timing; the
    limit sits above the largest single gap of sound tiny runs (~0.07)."""
    new = tmp_path / "t"
    shutil.copytree(tree, new)
    man = json.loads((new / "BENCHMARK.json").read_text())
    traffic = json.loads((new / "perfbench/traffic/tclosed.json").read_text())
    traffic.update(temperature_mix=0.0,
                   check={"tokens": 10**6, "max_requests": 10**6})
    write(new / "perfbench/traffic/tgreedy.json", traffic)
    man["workloads"].append({"name": "tiny-moe.tgreedy", "config": "tiny-moe",
                             "traffic": "tgreedy", "chips": 1, "why": "test"})
    write(new / "BENCHMARK.json", man)
    write(new / "perfbench/limits/tiny-moe.tgreedy.json",
          {"mean_logit_gap": {"limit": 0.004},
           "max_request_mean_gap": {"limit": 0.1, "min_request_tokens": 1},
           "min_tokens": 16})
    assert run(new, "tiny-moe.tgreedy")["correct"]
    monkeypatch.setattr(paged_lm, "_sample",
                        _one_slot_altered(paged_lm._sample))
    r = run(new, "tiny-moe.tgreedy")
    c = r["checks"]["max_request_mean_gap"]
    assert not r["correct"] and c["value"] > c["limit"], r["checks"]


def test_new_files_are_found_by_name(tree, tmp_path):
    """A configuration, a traffic mix, a cell and an end-to-end and a
    per-layer metric added as files and manifest entries, no code edited."""
    new = tmp_path / "t"
    shutil.copytree(tree, new)
    man = json.loads((new / "BENCHMARK.json").read_text())
    arch = json.loads((new / "perfbench/configs/tiny-dense.json").read_text())
    arch["perfbench"]["arch"]["n_layers"] = 3
    write(new / "perfbench/configs/tiny-deep.json", arch)
    man["configs"].append({"name": "tiny-deep", "source": "test",
                           "file": "perfbench/configs/tiny-deep.json",
                           "reduced": [], "why": "test"})
    traffic = json.loads((new / "perfbench/traffic/tclosed.json").read_text())
    traffic["clients"] = 3
    write(new / "perfbench/traffic/tthree.json", traffic)
    man["workloads"].append({"name": "tiny-deep.tthree", "config": "tiny-deep",
                             "traffic": "tthree", "chips": 1, "why": "test"})
    write(new / "perfbench/limits/tiny-deep.tthree.json",
          json.loads((new / "perfbench/limits/tiny-dense.tclosed.json")
                     .read_text()))
    (new / "perfbench/end_to_end/requests_per_s.py").write_text(
        "def read(ctx):\n"
        "    r = ctx.record\n"
        "    done = [s for s in r.sent if s.token_times\n"
        "            and r.t0 <= s.token_times[-1] <= r.t1]\n"
        "    return len(done) / (r.t1 - r.t0)\n")
    (new / "perfbench/per_layer/prompt_tokens.batch.py").write_text(
        "def read(ctx):\n"
        "    return sum(s.n_valid for s in ctx.record.steps)\n")
    man["end_to_end"].append({"name": "requests_per_s", "unit": "1/s",
                              "better": "higher", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["tiny-deep.tthree"]})
    man["per_layer"].append({"name": "prompt_tokens.batch", "unit": "tokens",
                             "better": "higher", "source": "program_counter",
                             "layer": "model step", "moves": "requests_per_s"})
    write(new / "BENCHMARK.json", man)
    cell = manifest.cell(new, "tiny-deep.tthree")
    assert [m["name"] for m in cell.per_layer] == ["prompt_tokens.batch"]
    assert cell.arch["n_layers"] == 3 and cell.traffic["clients"] == 3
    r = run(new, "tiny-deep.tthree")
    assert r["correct"]
    assert set(r["metrics"]) == {"requests_per_s", "setup_s"}
    assert manifest.reader(new, "per_layer", "prompt_tokens.batch")


def _add_shared_expert_family(tree):
    """An architecture that the decoder's files cannot build, a tiny MoE
    with one shared expert of the routed experts' width (the port serves
    it through ``n_shared_experts``), added as new files and new entries:
    a reference, an adapter, a configuration, limits and manifest
    entries.  Returns the files that were in the tree before."""
    before = {p: p.read_bytes() for p in tree.rglob("*") if p.is_file()}
    here = Path(__file__).parent / "shared_expert"
    base = tree / "perfbench"
    shutil.copy(here / "reference.py", base / "reference/shared.py")
    shutil.copy(here / "adapter.py", base / "adapters/shared.py")
    write(base / "configs/tiny-shared.json", {"perfbench": {
        "arch": dict(MOE, n_shared_experts=1),
        "reference": "perfbench/reference/shared.py",
        "adapter": "perfbench/adapters/shared.py"}})
    # set from the CPU readings of 8 seeds (the program / its shared
    # expert left out): mean gap <= 0.0029 / >= 0.32; largest request
    # mean <= 0.0118 / >= 0.49
    write(base / "limits/tiny-shared.tclosed.json",
          {"mean_logit_gap": {"limit": 0.01},
           "max_request_mean_gap": {"limit": 0.1, "min_request_tokens": 8},
           "min_tokens": 16})
    man = json.loads((tree / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-shared", "source": "test",
                           "file": "perfbench/configs/tiny-shared.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny-shared.tclosed",
                             "config": "tiny-shared", "traffic": "tclosed",
                             "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m and "tiny-moe.tclosed" in m["workloads"]:
            m["workloads"].append("tiny-shared.tclosed")
    write(tree / "BENCHMARK.json", man)
    return before


def _shared_expert_dropped(p, x):
    """The port's shared expert, which only the shared-expert family has
    in this tree, left out of each MoE layer's output."""
    return torch.zeros_like(x)


@pytest.mark.parametrize("shared", ["served", "dropped"])
def test_new_architecture_is_found_by_name(tree, tmp_path, monkeypatch,
                                           shared):
    """The architecture case of :func:`test_new_files_are_found_by_name`:
    a family with its own reference module and program adapter, no file
    of the tree changed; its sound run is correct, and a run whose
    program leaves the shared expert out is not."""
    new = tmp_path / "t"
    shutil.copytree(tree, new)
    old_man = json.loads((new / "BENCHMARK.json").read_text())
    before = _add_shared_expert_family(new)
    changed = {p for p, data in before.items() if p.read_bytes() != data}
    assert changed == {new / "BENCHMARK.json"}
    man = json.loads((new / "BENCHMARK.json").read_text())
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert [e["name"] for e in man[group][:len(old_man[group])]] == \
            [e["name"] for e in old_man[group]]
    cell = manifest.cell(new, "tiny-shared.tclosed")
    # the decoder's adapter cannot build it: the shared leaves go undrawn
    decoder = manifest.cell(new, "tiny-moe.tclosed").adapter
    with pytest.raises(RuntimeError, match="shared"):
        decoder.build_lm(cell.adapter.model_config(cell.arch, "t"),
                         cell.arch, SEED, "cpu", manifest.cell(
                             new, "tiny-moe.tclosed").ref)
    if shared == "dropped":
        monkeypatch.setattr(layers, "apply_mlp", _shared_expert_dropped)
    r = run(new, "tiny-shared.tclosed")
    assert r["correct"] == (shared == "served"), r["checks"]
    assert r["checks"]["tokens_judged"]["value"] >= 16


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")


def test_run_without_a_card_prints_no_result(no_card):
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL,
         "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0
    assert "{" not in p.stdout and "metrics" not in p.stdout


def test_benchmark_alone_without_the_program_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and perfbench/ has no program
    to measure: a run there fails before it prints anything."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path[:0] = ['.'];"
            "from perfbench.run import run_cell;"
            f"print(run_cell('.', '{CELL}', 1, 1.0, False,"
            " torch.device('cpu'), time.perf_counter()))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "repro_torch" in p.stderr
    assert "metrics" not in p.stdout
