"""The serve engine's spans (CPU, smoke arch): under ``torch.profiler``
every step is a ``serve.step`` tiled by its six phases in order; with no
profiler running ``record_function`` is never entered; the spans change
no served token."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.serve import ServeEngine
from repro_torch.serve.spans import span

PROMPTS = [list(range(1, 6)), list(range(20, 39)), [40, 41]]
CHILDREN = {kind: ["serve.schedule", "serve.sync_cache", f"serve.{kind}",
                   "serve.readback", "serve.accept", "serve.account"]
            for kind in ("decode", "prefill")}


@pytest.fixture(scope="module")
def setup():
    cfg = registry.smoke("qwen2-1.5b")
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def serve(setup):
    """A tiny engine on three requests (one greedy, one sampled, one over
    three chunks), stepped to the end; returns it and the requests."""
    cfg, params = setup
    eng = ServeEngine(cfg, params, slots=4, max_len=48, page_size=8,
                      prefill_chunk=8, device="cpu")
    rs = [eng.submit(p, max_new_tokens=m, temperature=t, seed=s)
          for p, m, t, s in zip(PROMPTS, (6, 5, 8), (0.0, 0.7, 0.0),
                                (0, 9, 0))]
    eng.run()
    eng.assert_no_leaks()
    return eng, rs


def serve_traced(setup, tmp_path):
    """``serve`` under a CPU profiler; returns the requests and the
    program's spans from the exported chrome trace, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng, rs = serve(setup)
        assert not eng.step()              # one idle step
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith("serve.")))
    return rs, spans


def steps_with_children(spans):
    """Each ``serve.step`` with the spans that lie inside it."""
    out = []
    for t0, t1, name in spans:
        if name == "serve.step":
            inside = [s for s in spans if t0 <= s[0] and s[1] <= t1
                      and s[2] != "serve.step"]
            out.append(((t0, t1), inside))
    return out


def test_each_step_is_tiled_by_its_phases_in_order(setup, tmp_path):
    rs, spans = serve_traced(setup, tmp_path)
    steps = steps_with_children(spans)
    assert len(steps) == sum(1 for s in spans if s[2] == "serve.step")
    seen = {"decode": 0, "prefill": 0}
    for (t0, t1), inside in steps:
        names = [s[2] for s in inside]
        if names == ["serve.schedule"]:    # the idle step
            continue
        kind = "decode" if "serve.decode" in names else "prefill"
        assert names == CHILDREN[kind]
        # nested in the step, one after another
        for (a0, a1, _), (b0, _, _) in zip(inside, inside[1:]):
            assert a1 <= b0
        assert inside[0][0] >= t0 and inside[-1][1] <= t1
        assert sum(s1 - s0 for s0, s1, _ in inside) >= 0.9 * (t1 - t0)
        seen[kind] += 1
    # 3 prompts of 1 + 3 + 1 chunks; decode steps until the last request
    # has its 8 tokens
    assert seen["prefill"] == 5
    assert seen["decode"] >= 7
    assert [s[2] for s in steps[-1][1]] == ["serve.schedule"]
    assert all(len(r.out_tokens) == m for r, m in zip(rs, (6, 5, 8)))


def test_no_profiler_never_enters_record_function(setup, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("serve.step") is span("serve.decode")
    _, rs = serve(setup)
    assert all(r.out_tokens for r in rs)


def test_spans_change_no_served_token(setup, tmp_path):
    _, plain = serve(setup)
    traced, _ = serve_traced(setup, tmp_path)
    assert [r.out_tokens for r in traced] == [r.out_tokens for r in plain]
