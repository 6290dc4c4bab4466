"""The highest Poisson rate an open-loop cell's engine sustains.

    python3 perfbench/sweep.py --workload <cell> --rates 1.5,2,2.5 \
        --seeds 11,12,13 --seconds 20

One process draws the weights once (from the first seed) and then, for
each rate and each seed, runs the cell as ``run.py`` runs it on a fresh
engine: the warm-up, the traffic file's ramp at that rate, then the
window.  Each such run prints one JSON line: the backlog (requests due
that have no first token yet) sampled at every step of the window, its
mean over the window's first and second halves, TTFT and ITL tails, and
the output tokens per second.  A run sustains its rate when the second
half's mean backlog is at most the first half's plus one request: a
queue that grows through the window is what a rate beyond capacity
shows, and a mean over hundreds of steps, with one request of room,
keeps a Poisson run's own noise from reading as growth.  A rate is
sustained when every seed's run sustains it.  The last line names the
highest rate sustained, below the lowest that is not, and four fifths
of it: the rate the cell's traffic file then fixes.
"""
import time

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def backlog(rec, t: float) -> int:
    return sum(1 for s in rec.sent if s.due <= t
               and not (s.token_times and s.token_times[0] <= t))


def ttft_p95_ms(rec, lo: float, hi: float):
    """(95th percentile of first token less due time, requests) over the
    requests due in [lo, hi); one never answered is infinitely late."""
    from perfbench.readers import percentile
    xs = [(s.token_times[0] - s.due) * 1e3 if s.token_times
          else float("inf") for s in rec.sent if lo <= s.due < hi]
    return (percentile(xs, 95) if xs else None), len(xs)


def mean_backlog(rec, steps: list) -> float:
    return (sum(backlog(rec, s.t1) for s in steps) / len(steps)
            if steps else 0.0)


def sustained(row: dict) -> bool:
    return row["backlog_mean_second_half"] <= \
        row["backlog_mean_first_half"] + 1


def one_run(cell, system, rate: float, seconds: float, seed: int,
            device="cuda") -> dict:
    import torch

    from perfbench import client, loadgen, program, readers
    traffic = dict(cell.traffic, rate_rps=rate, drain_seconds=0)
    system.engine = None          # the last run's page pool goes first
    gc.collect()
    system.engine = program.engine(system.cfg, system.lm, traffic["engine"],
                                   device, time.perf_counter)
    client.warm_up(system.engine, traffic, cell.arch["vocab_size"])
    specs = loadgen.requests(traffic, cell.arch["vocab_size"], seed, seconds)
    rec = client.Client(system.engine, traffic, specs, seed).run(seconds)
    mid = (rec.t0 + rec.t1) / 2
    ctx = readers.Context(cell.arch, cell.ref, traffic, rec, 0.0)
    steps = readers.window_steps(ctx)
    tokens = sum(1 for s in rec.sent for t in s.token_times
                 if readers.in_window(ctx, t))
    gaps = []
    for s in rec.sent:
        t = [x for x in s.token_times if readers.in_window(ctx, x)]
        gaps += [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    out = {"rate_rps": rate, "seed": seed,
           "backlog_start": backlog(rec, rec.t0),
           "backlog_end": backlog(rec, rec.t1),
           "backlog_mean_first_half": mean_backlog(
               rec, [s for s in steps if s.t1 < mid]),
           "backlog_mean_second_half": mean_backlog(
               rec, [s for s in steps if s.t1 >= mid]),
           "ttft_p95_ms": ttft_p95_ms(rec, rec.t0, rec.t1),
           "ttft_p95_ms_first_half": ttft_p95_ms(rec, rec.t0, mid),
           "ttft_p95_ms_second_half": ttft_p95_ms(rec, mid, rec.t1),
           "itl_p95_ms": readers.percentile(gaps, 95) if gaps else None,
           "tokens_per_s": tokens / (rec.t1 - rec.t0),
           "decode_step_ms": readers.step_ms(ctx, "decode"),
           "prefill_chunk_ms": readers.step_ms(ctx, "prefill"),
           "slot_occupancy_pct": 100 * sum(s.occupancy for s in steps)
           / max(1, len(steps))}
    out["sustained"] = sustained(out)
    system.engine = None
    del rec, ctx
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def knee(rows: list) -> dict:
    """The highest rate sustained below the lowest that is not."""
    rates = sorted({r["rate_rps"] for r in rows})
    ok = {x: all(r["sustained"] for r in rows if r["rate_rps"] == x)
          for x in rates}
    best = None
    for x in rates:
        if not ok[x]:
            break
        best = x
    return {"knee_rps": best,
            "fixed_rps": None if best is None else 0.8 * best,
            "sustained": {str(x): ok[x] for x in rates}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from perfbench import manifest, program
    cell = manifest.cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    system = program.start(cell, seeds[0], "cuda", time.perf_counter)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        for seed in seeds:
            rows.append(one_run(cell, system, rate, args.seconds, seed))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(knee(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
