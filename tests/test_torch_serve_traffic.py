"""``repro_torch.launch.serve_traffic`` (Poisson traffic through the engine,
page-pool preemption) against the reference's ``examples/serve_traffic.py``
and inside the port (CPU).

Against the reference, at the example's own settings (smoke arch, 12
requests, ``--pressure``): float32 weights from the reference's
``init_params(key(0))``, carried by ``checkpoint.convert``; the schedule
(84 steps, 3 preemptions, 233 tokens, backpressure, each request's
preemptions and output length), the virtual TTFT / ITL summaries and the
greedy streams equal the reference engine's under the reference's
``drive``.  Sampled streams are the port's own and never compared with
JAX's.  Both ``main()``s print the same lines, word for word.

Inside the port, at the card's ``--full`` geometry on a 2-layer smoke
model (float32): the pressured pool (97 pages) preempts at least 10 of the 32
requests, and every stream, greedy and sampled, equals the unpressured
run's.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import api as jax_api
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import drive as jax_drive
from repro.serve import poisson_workload as jax_workload
from repro.serve.metrics import summarize_ms as jax_summarize_ms
from repro_torch.checkpoint import convert
from repro_torch.configs import registry
from repro_torch.launch import serve_traffic as st
from repro_torch.models import api
from repro_torch.serve.scheduler import RequestState

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = Path(__file__).resolve().parents[1]
REQUESTS = 12
SLOTS = 8


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_traffic", ROOT / "examples" / "serve_traffic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twin_matches_the_reference_at_the_examples_settings():
    geom = st.REFERENCE
    jcfg = dataclasses.replace(jax_registry.smoke("qwen2-1.5b"),
                               dtype="float32")
    tcfg = dataclasses.replace(registry.smoke("qwen2-1.5b"), dtype="float32")
    jparams = jax_api.init_params(jax.random.key(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    n_pages = st.pressure_pages(geom, SLOTS)
    assert n_pages == 1 + SLOTS * 4

    jspecs = jax_workload(REQUESTS, rate_rps=500.0, seed=7,
                          vocab_size=jcfg.vocab_size, prompt_len=(4, 40),
                          out_len=(8, 48))
    tspecs = st.workload(tcfg, geom, requests=REQUESTS)
    assert [dataclasses.astuple(s) for s in tspecs] == \
        [dataclasses.astuple(s) for s in jspecs]

    jeng = JaxServeEngine(jcfg, jparams, slots=SLOTS, max_len=96,
                          page_size=8, prefill_chunk=16, n_pages=n_pages)
    jres = jax_drive(jeng, jspecs, seconds_per_step=1e-3)
    jeng.assert_no_leaks()
    out = st.run_traffic(tcfg, tparams, tspecs, geom, slots=SLOTS,
                         n_pages=n_pages, device="cpu")

    sched = st.schedule(out)
    jm = jeng.metrics.summary()
    assert (sched["steps"], sched["preemptions"], sched["tokens"]) == \
        (84, 3, 233)
    assert (sched["steps"], sched["backpressured"]) == \
        (jres["steps"], jres["backpressured"])
    for key in ("decode_steps", "prefill_chunks", "preemptions",
                "tokens_sampled", "peak_in_flight", "occupancy_mean",
                "pool_util_mean"):
        assert out["metrics"][key] == jm[key], key
    assert sched["requests"] == [(r.preemptions, len(r.out_tokens))
                                 for r in jres["requests"]]
    done = [r for r in jres["requests"] if r.state.value == "finished"]
    assert len(done) == REQUESTS
    assert out["ttft_ms"] == jax_summarize_ms(
        [r.metrics.ttft for r in done if r.metrics.ttft is not None])
    assert out["itl_ms"] == jax_summarize_ms(
        [i for r in done for i in r.metrics.itls])
    greedy = 0
    for jr, tr in zip(jres["requests"], out["requests"]):
        assert tr.state is RequestState.FINISHED
        assert len(tr.out_tokens) == tr.params.max_new_tokens
        if tr.params.temperature == 0.0:
            assert tr.out_tokens == jr.out_tokens, tr.rid
            greedy += 1
    assert greedy >= 4
    assert sum(r.preemptions > 0 for r in out["requests"]) >= 1
    assert len(out["step_ms"]["decode"]) == out["metrics"]["decode_steps"]
    assert len(out["step_ms"]["prefill"]) == \
        out["metrics"]["prefill_chunks"]


def test_main_prints_the_reference_examples_lines(monkeypatch, capsys):
    """``main --device cpu --pressure`` against the reference example's
    ``main --pressure`` (bfloat16 smoke models, each package's own
    weights): the schedule does not depend on token values, so the lines
    agree word for word."""
    ref = _reference_example()
    monkeypatch.setattr(sys, "argv", ["serve_traffic.py", "--pressure"])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    out = st.main(["--device", "cpu", "--pressure"])
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 4 and want[-1].startswith("pressure run")
    assert got[:4] == want
    assert got[4].startswith("wall ")
    assert out["metrics"]["preemptions"] > 0
    assert all(r.state is RequestState.FINISHED for r in out["requests"])


def test_full_geometry_streams_survive_preemption():
    """The card phase's workload on a 2-layer float32 smoke model: at 97
    pages at least 10 requests are preempted, and every stream, greedy and
    sampled, equals the one of an unpressured pool."""
    cfg = dataclasses.replace(registry.smoke("qwen2-1.5b"), n_layers=2,
                              dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = st.workload(cfg, st.FULL)
    n_pages = st.pressure_pages(st.FULL, SLOTS)
    assert n_pages == 97
    runs = [st.run_traffic(cfg, params, specs, st.FULL, slots=SLOTS,
                           n_pages=pages, device="cpu")
            for pages in (n_pages, None)]
    pressured, plain = (st.schedule(r) for r in runs)
    assert sum(p > 0 for p, _ in pressured["requests"]) >= 10
    assert plain["preemptions"] == 0
    assert pressured["prefill_chunks"] > plain["prefill_chunks"]
    assert [n for _, n in pressured["requests"]] == \
        [s.max_new_tokens for s in specs]
    assert {s.temperature for s in specs} == {0.0, 0.8}
    for a, b in zip(*(r["requests"] for r in runs)):
        assert a.state is b.state is RequestState.FINISHED
        assert a.out_tokens == b.out_tokens, a.rid


def test_run_traffic_wants_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.smoke("qwen2-1.5b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = st.workload(cfg, st.REFERENCE, requests=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.run_traffic(cfg, params, specs, st.REFERENCE)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.main(["--requests", "2"])
