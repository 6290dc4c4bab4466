"""The benchmark's copy of the program's generator, and the run's requests
drawn from a traffic file and a seed."""
from __future__ import annotations

import dataclasses
import json
from collections import Counter

import pytest
from perfbench_tiny import ROOT

from perfbench import loadgen
from repro_torch.serve import loadgen as program_loadgen

BIG_SEED = 2**31 + 987_654_321


@pytest.mark.parametrize("kw", [
    dict(n_requests=40, rate_rps=8.0, seed=7, vocab_size=256),
    dict(n_requests=25, rate_rps=3.5, seed=BIG_SEED, vocab_size=151_936,
         prompt_len=(64, 1024), out_len=(16, 256), temperature_mix=0.5),
])
def test_copy_equals_the_programs_generator(kw):
    ours = [dataclasses.asdict(s) for s in loadgen.poisson_workload(**kw)]
    theirs = [dataclasses.asdict(s)
              for s in program_loadgen.poisson_workload(**kw)]
    assert ours == theirs


@pytest.mark.parametrize("mix", sorted(
    p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json")))
def test_seed_permutes_the_same_work(mix):
    traffic = json.loads((ROOT / "perfbench" / "traffic" /
                          f"{mix}.json").read_text())
    a = loadgen.requests(traffic, 1000, BIG_SEED, 40)
    b = loadgen.requests(traffic, 1000, BIG_SEED, 40)
    c = loadgen.requests(traffic, 1000, 12345, 40)
    assert [dataclasses.asdict(s) for s in a] == \
        [dataclasses.asdict(s) for s in b]
    assert [s.prompt for s in a] != [s.prompt for s in c]
    for field in ("max_new_tokens", "temperature"):
        assert Counter(getattr(s, field) for s in a) == \
            Counter(getattr(s, field) for s in c)
    assert Counter(len(s.prompt) for s in a) == \
        Counter(len(s.prompt) for s in c)
    lo, hi = traffic["prompt_len"]
    assert all(lo <= len(s.prompt) <= hi for s in a)
    lo, hi = traffic["out_len"]
    assert all(lo <= s.max_new_tokens <= hi for s in a)
    assert all(0 <= t < 1000 for s in a for t in s.prompt)
    if traffic["loop"] == "open":
        assert a[-1].arrival == pytest.approx(c[-1].arrival)
        span = traffic["ramp_seconds"] + 40 + traffic["drain_seconds"]
        assert a[-1].arrival > span


def test_first_fractions_are_the_same_set_for_every_seed():
    f1 = loadgen.first_fractions(64, 1)
    f2 = loadgen.first_fractions(64, BIG_SEED)
    assert sorted(f1) == sorted(f2)
    assert list(f1) != list(f2)
    assert 0 < min(f1) and max(f1) < 1
