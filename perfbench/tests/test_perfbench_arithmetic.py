"""End-to-end and per-layer arithmetic on synthetic records, the roofline
and FLOP counts on hand-computed shapes, and the trace reader on a
synthetic chrome trace."""
from __future__ import annotations

import types

import pytest
from perfbench_tiny import ROOT

from perfbench import check, client, manifest, readers, sweep, trace
from perfbench.reference import decoder
from perfbench.roofline import counts

QWEN = {"n_layers": 28, "d_model": 1536, "n_heads": 12, "n_kv_heads": 2,
        "d_head": 128, "d_ff": 8960, "vocab_size": 151936, "n_experts": 0,
        "top_k": 0}
DBRX = {"n_layers": 8, "d_model": 6144, "n_heads": 48, "n_kv_heads": 8,
        "d_head": 128, "d_ff": 10752, "vocab_size": 100352, "n_experts": 16,
        "top_k": 4}


def e2e(name):
    return manifest.reader(ROOT, "end_to_end", name)


def layer(name):
    return manifest.reader(ROOT, "per_layer", name)


def sent(due, times, submitted=None):
    s = client.Sent(spec=None, due=due, client=0, max_new_tokens=len(times))
    s.token_times = list(times)
    s.submitted = due if submitted is None else submitted
    return s


def ctx(sent_list, steps=(), t0=10.0, t1=20.0, trace_summary=None,
        arch=QWEN):
    rec = client.Record(sent=list(sent_list), steps=list(steps), t0=t0, t1=t1)
    return readers.Context(arch, decoder, {"engine": {"page_size": 16}},
                           rec, 7.5, trace_summary)


def test_setup_s_reads_the_time_to_the_window():
    s = [sent(9.0, [9.5, 10.0, 12.0, 19.99, 20.0, 20.5])]
    assert e2e("setup_s")(ctx(s)) == 7.5


def test_ttft_counts_from_the_due_time_and_a_stall_moves_the_tail():
    # the sweep's TTFT tail: 100 requests due in the window, each answered
    # 50 ms after its due time; one due before the window is not counted
    def p95(xs):
        return sweep.ttft_p95_ms(client.Record(sent=xs, steps=[]), 10.0,
                                 20.0)
    base = [sent(10.0 + 0.09 * i, [10.05 + 0.09 * i]) for i in range(100)]
    early = [sent(9.0, [15.0])]
    assert p95(base + early) == (pytest.approx(50.0), 100)
    # the client submitted late (a stall): latency still runs from due
    late = [sent(10.0 + 0.09 * i, [10.05 + 0.09 * i], submitted=10.04
                 + 0.09 * i) for i in range(100)]
    assert p95(late)[0] == pytest.approx(50.0)
    # a 2-second stall that holds the last 10 requests' first tokens
    stalled = [sent(s.due, [max(s.token_times[0], 19.0)]) for s in base]
    assert p95(stalled)[0] > 500.0
    # an unanswered request is infinitely late
    lost = base[:90] + [sent(15.0 + 0.01 * i, []) for i in range(10)]
    assert p95(lost)[0] == float("inf")


def test_sweep_sustains_a_rate_whose_queue_does_not_grow():
    # requests due every 0.1 s; steps end every 0.05 s over [10, 20)
    steps = [client.Step("window", "decode", 10.0 + 0.05 * i,
                         10.05 + 0.05 * i, [1]) for i in range(200)]
    steady = [sent(10.0 + 0.1 * i, [10.3 + 0.1 * i]) for i in range(100)]
    growing = [sent(10.0 + 0.1 * i, [10.3 + 0.15 * i]) for i in range(100)]
    halves = []
    for xs in (steady, growing):
        rec = client.Record(sent=xs, steps=steps, t0=10.0, t1=20.0)
        halves.append([sweep.mean_backlog(rec, [s for s in steps
                                                if (s.t1 < 15.0) == first])
                       for first in (True, False)])
    assert halves[0][0] == pytest.approx(halves[0][1], abs=0.2)
    assert halves[1][1] > halves[1][0] + 1

    def row(rate, first, second):
        r = {"rate_rps": rate, "backlog_mean_first_half": first,
             "backlog_mean_second_half": second}
        r["sustained"] = sweep.sustained(r)
        return r
    rows = [row(1.0, 2.0, 2.5), row(1.0, 1.0, 1.9), row(2.0, 1.0, 2.5),
            row(2.0, 1.0, 1.0), row(3.0, 1.0, 1.0)]
    k = sweep.knee(rows)
    assert k["knee_rps"] == 1.0 and k["fixed_rps"] == pytest.approx(0.8)
    assert k["sustained"] == {"1.0": True, "2.0": False, "3.0": True}


def test_itl_takes_every_gap_inside_the_window():
    s = [sent(10.0, [10.0 + 0.04 * i for i in range(100)]),
         sent(10.0, [10.0 + 0.04 * i for i in range(100)])]
    assert e2e("itl_p95_ms")(ctx(s)) == pytest.approx(40.0)
    stall = [sent(10.0, [10.0 + 0.04 * i + (2.0 if i >= 50 else 0.0)
                         for i in range(100)]) for _ in range(2)]
    gaps = [40.0] * 98 + [2040.0] * 2
    assert e2e("itl_p95_ms")(ctx(stall)) == pytest.approx(
        readers.percentile(gaps, 95))
    # a stall that affects 10% of the gaps moves the 95th percentile
    many = [sent(10.0, [10.0 + 0.04 * i + 0.5 * (i // 10) for i in
                        range(100)]) for _ in range(2)]
    assert e2e("itl_p95_ms")(ctx(many)) == pytest.approx(540.0)


def test_request_mean_reads_one_bad_request_among_sound_ones():
    # five sound requests at a mean gap of 0.65, one garbage one at 6: the
    # pooled mean stays under a limit of 2, the largest request mean not
    sound, bad = [100, 65.0], [100, 600.0]
    r = {"max_logit_gap": 9.0, "mean_logit_gap": (5 * 65 + 600) / 600,
         "per_request": [sound] * 5 + [bad], "tokens": 600}
    limits = {"mean_logit_gap": {"limit": 2.0},
              "max_request_mean_gap": {"limit": 2.0,
                                       "min_request_tokens": 32},
              "min_tokens": 200}
    ok, checks = check.verdict(r, limits)
    assert checks["mean_logit_gap"]["value"] < 2.0
    assert checks["max_request_mean_gap"]["value"] == pytest.approx(6.0)
    assert not ok
    # a request under min_request_tokens is not read alone
    r["per_request"] = [sound] * 5 + [[4, 12.0]]
    ok, checks = check.verdict(r, limits)
    assert checks["max_request_mean_gap"]["value"] == pytest.approx(0.65)
    assert ok
    # where none is that long, all of them count as one
    assert check.request_mean_max([[10, 20.0], [10, 0.0]], 32) == \
        pytest.approx(1.0)


def test_sample_draws_across_slots():
    """After the longest request, one request a slot in turn: two slots
    that served one short greedy request each among twenty longer ones
    in the other two are judged on every seed; sampled requests never
    are, and the sample stops at the tokens asked for."""
    def req(rid, slot, n, temperature=0.0):
        return types.SimpleNamespace(
            rid=rid, slot=slot, prompt=[1] * 8, out_tokens=[2] * n,
            params=types.SimpleNamespace(temperature=temperature))
    reqs = [req(0, 0, 30)]
    reqs += [req(1 + i, 2 * (i % 2), 20) for i in range(20)]
    reqs += [req(30, 1, 5), req(31, 3, 5), req(32, 1, 40, 0.8),
             req(33, 3, 40, 0.8)]
    for seed in range(20):
        got = check.sample(reqs, 2**31 + seed, 64, 12)
        assert got[0].rid == 0
        assert {r.slot for r in got} == {0, 1, 2, 3}
        assert all(r.params.temperature == 0.0 for r in got)
        assert sum(len(r.out_tokens) for r in got) >= 64
        assert sum(len(r.out_tokens) for r in got[:-1]) < 64
    assert len(check.sample(reqs, 1, 10**6, 5)) == 5


def test_step_readers():
    steps = [client.Step("window", "decode", 10.0 + i, 10.05 + i, [5, 9],
                         occupancy=0.5) for i in range(5)]
    steps += [client.Step("window", "prefill", 16.0, 16.2, [], start=0,
                          n_valid=100, occupancy=1.0),
              client.Step("ramp", "decode", 1.0, 3.0, [5], occupancy=0.0)]
    c = ctx([], steps)
    assert layer("decode_step_ms.chat")(c) == pytest.approx(50.0)
    assert layer("prefill_chunk_ms.chat")(c) == pytest.approx(200.0)
    flops = 5 * decoder.step_flops(QWEN, "decode", [5, 9]) + \
        decoder.step_flops(QWEN, "prefill", [], 0, 100)
    assert layer("mfu_pct.chat")(c) == pytest.approx(
        100 * flops / (10.0 * 989e12))
    assert layer("device_idle_pct.chat")(c) is None
    assert layer("paged_attention_roofline.chat")(c) is None


def test_counts_on_hand_computed_shapes():
    # qwen2: one layer's attention + MLP parameters
    attn = 1536 * 1536 * 2 + 1536 * 256 * 2
    assert decoder.active_params(QWEN) == 28 * (attn + 3 * 1536 * 8960)
    # dbrx: router + 4 of 16 experts
    attn = 6144 * 6144 * 2 + 6144 * 1024 * 2
    assert decoder.active_params(DBRX) == 8 * (attn + 6144 * 16
                                              + 4 * 3 * 6144 * 10752)
    # a decode row attending 100 tokens, page 16: K and V rows, q and out,
    # 7 table entries and the length, every layer
    assert decoder.attention_layers(QWEN) == 28
    assert (decoder.moe_layers(QWEN), decoder.moe_layers(DBRX)) == (0, 8)
    f, b = counts.paged_attention(QWEN, [100], 16, 28)
    assert f == 28 * 4 * 12 * 128 * 100
    assert b == 28 * (2 * 100 * 2 * 128 * 2 + 2 * 12 * 128 * 2 + 7 * 4 + 4)
    f, b = counts.dispatch_combine(DBRX, 10, 8)
    per = (10 * 6144 * 2 + 40 * 4 + 40 * 6144 * 2) + \
        (40 * 6144 * 2 + 40 * 6 + 10 * 6144 * 2)
    assert b == 8 * per and f == 8 * 2 * 40 * 6144
    # prefill of 4 tokens at positions 10..13 attends 11+12+13+14 keys;
    # the head runs on the last position only
    p = decoder.step_flops(QWEN, "prefill", [], 10, 4)
    assert p == 4 * 2 * decoder.active_params(QWEN) \
        + 4 * 28 * 12 * 128 * 50 + 2 * 1536 * 151936
    # the bound of the larger of FLOPs and bytes
    assert counts.roofline_pct(989e12, 0, 2.0) == pytest.approx(50.0)
    assert counts.roofline_pct(0, 3.35e12, 4.0) == pytest.approx(25.0)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def synthetic_trace():
    """Two steps, 0-92 us (decode) and 150-300 us (prefill); kernels of
    the first launched at 10 and 20, of the second at 160."""
    return [
        _x("user_annotation", "perfbench.step.3", 0, 92),
        _x("user_annotation", "perfbench.step.4", 150, 150),
        _x("cpu_op", "aten::mm", 5, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 160, 2, correlation=3),
        _x("cpu_op", "aten::item", 60, 30),
        _x("kernel", "void (anonymous namespace)::paged_partition_kernel<"
           "__nv_bfloat16, 16, 1>((anonymous namespace)::Args)", 30, 20,
           correlation=1),
        _x("kernel", "ampere_gemm", 40, 20, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH", 90, 5),
        _x("kernel", "ampere_gemm", 200, 50, correlation=3),
    ]


def test_trace_summary_busy_idle_and_launches():
    s = trace.summarize(synthetic_trace(), {3: "decode", 4: "prefill"})
    assert s.window_s == pytest.approx(300e-6)
    # busy: 30-60, 90-95, 200-250 = 85 us
    assert s.busy_s == pytest.approx(85e-6)
    assert s.launches == {3: 2, 4: 1}
    assert s.kernel_s["ampere_gemm"] == pytest.approx(70e-6)
    assert s.kind_kernel_s["prefill"] == {"ampere_gemm": pytest.approx(50e-6)}
    assert sum(s.idle_by_host.values()) == pytest.approx(215e-6)
    # idle 60-90 begins under aten::item in the decode step
    assert s.idle_by_host["aten::item [decode]"] == pytest.approx(30e-6)
    # idle 95-200 begins between steps: the client's
    assert s.idle_by_host["client, between engine steps"] == \
        pytest.approx(105e-6)
    # idle 0-30 and 250-300 begin inside steps, under no host event
    assert s.idle_by_host["host in engine.step [decode]"] == \
        pytest.approx(30e-6)
    assert s.idle_by_host["host in engine.step [prefill]"] == \
        pytest.approx(50e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "ampere_gemm"
    assert len(b["idle_gaps"]) <= 10
    assert trace.summarize(synthetic_trace(), {}) is None


def test_readers_on_a_traced_decode_step():
    s = trace.summarize(synthetic_trace(), {3: "decode", 4: "prefill"})
    steps = [None, None, None,
             client.Step("trace", "decode", 0, 1, [100, 50]),
             client.Step("trace", "prefill", 1, 2, [], 0, 10)]
    c = ctx([], steps, trace_summary=s)
    assert layer("launches_per_decode_step.chat")(c) == 2
    assert layer("device_idle_pct.chat")(c) == pytest.approx(
        100 * (1 - 85 / 300))
    f, b = counts.paged_attention(QWEN, [100, 50], 16, 28)
    assert layer("paged_attention_roofline.chat")(c) == pytest.approx(
        counts.roofline_pct(f, b, 20e-6))
    assert layer("moe_dispatch_combine_roofline.chat")(c) is None
    # a kernel is found by its function's name, whatever its namespace
    # or template arguments, and no other kernel's name counts for it
    assert readers.kernel_seconds(c, ("paged_partition_kernel",)) == \
        pytest.approx(20e-6)
    assert readers.kernel_seconds(c, ("partition_kernel",)) == 0
