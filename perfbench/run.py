"""Run one cell of the benchmark once on one CUDA card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic and limits by name
(:mod:`perfbench.manifest`), draws the weights from the seed on the card,
starts ``repro_torch``'s ServeEngine on the model that the
configuration's adapter builds, ramps the traffic to a steady state,
measures for ``--seconds``, and then, with the program freed, judges a
sample of the served tokens against the configuration's plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and ``breakdown``
in a traced run), then ``checks``: each number compared beside its limit,
which also end standard error.  Without a CUDA card, or with a module
of JAX or of the JAX package loaded, it prints no result and exits
non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def _say(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


class _Light:
    """What the check needs of a finished request, kept once the program
    is freed."""

    def __init__(self, sent):
        r = sent.req
        self.rid, self.prompt = r.rid, list(r.prompt)
        self.out_tokens, self.params = list(r.out_tokens), r.params
        self.slot = sent.slot


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> dict:
    """One run of one cell on ``device``; returns the result's fields."""
    import torch

    from perfbench import check, client, loadgen, manifest, program, readers
    from perfbench import trace as tracing

    cell = manifest.cell(root, name)
    arch, traffic = cell.arch, cell.traffic
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    system = program.start(cell, seed, device, clock=time.perf_counter)
    _say(f"weights and engine {time.perf_counter() - t:.3f} s "
         f"(process start to here {time.perf_counter() - t_start:.3f} s)")
    t = time.perf_counter()
    client.warm_up(system.engine, traffic, arch["vocab_size"])
    _say(f"warm-up {time.perf_counter() - t:.3f} s")
    specs = loadgen.requests(traffic, arch["vocab_size"], seed, seconds)
    tracer = tracing.Tracer(os.environ.get("TMPDIR")) if trace else None
    cl = client.Client(system.engine, traffic, specs, seed,
                       annotate=tracer.annotate if tracer else None)
    rec = cl.run(seconds, trace_steps=tracing.STEPS if trace else 0,
                 on_phase=tracer.on_phase if tracer else None)
    if cuda:
        torch.cuda.synchronize()
    _say(f"window starts {rec.t0 - t_start:.3f} s after process start; "
         f"{len(rec.steps)} steps, {len(rec.sent)} requests sent")
    longest = sorted(rec.steps, key=lambda s: s.t0 - s.t1)[:5]
    _say("longest steps: " + ", ".join(
        f"{s.kind} {s.phase} {1e3 * (s.t1 - s.t0):.1f} ms" for s in longest))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = (tracer.summary({i: s.kind for i, s in enumerate(rec.steps)})
               if tracer else None)
    ctx = readers.Context(arch, cell.ref, traffic, rec, rec.t0 - t_start,
                          summary)
    wanted = cell.per_layer if trace else cell.end_to_end
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in wanted:
        v = manifest.reader(root, kind, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    state, _ = program.request_states()
    if traffic["loop"] == "open":
        window = [s for s in rec.sent if rec.t0 <= s.due < rec.t1]
    else:
        window = [s for s in rec.sent if rec.t0 <= s.submitted < rec.t1]
    failed = sum(1 for s in window if s.refused or s.req.state in
                 (state.FAILED, state.CANCELLED))
    finished = [_Light(s) for s in rec.sent
                if s.req is not None and s.req.state is state.FINISHED]
    chk = traffic["check"]
    judged = check.sample(finished, seed, chk["tokens"], chk["max_requests"])
    result = {"attempted": len(window), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = tracing.breakdown(summary)
    if cuda:
        result["device"]["power_limit"] = card_power_limit()
    # the program's state goes before the reference runs
    del system, cl, finished, rec, ctx, summary
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings = check.judge(cell.ref, arch, seed, judged, device,
                           control=control)
    _say(f"reference over {readings['tokens']} tokens of "
         f"{readings['requests']} requests {time.perf_counter() - t:.3f} s")
    ok, checks = check.verdict(readings, cell.limits)
    result = {"correct": bool(ok), **result, "checks": checks}
    if control:
        result["readings"] = readings
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    # one process with one intra-op thread: the card does the work, and
    # idle worker threads on a shared host only spread the host's timings
    torch.set_num_threads(1)
    from perfbench import manifest
    chips = manifest.cell(ROOT, args.workload).chips
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}: the benchmark measures the port "
              f"alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
