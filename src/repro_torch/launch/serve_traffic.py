"""Poisson-traffic serving: the twin of the JAX package's
``examples/serve_traffic.py``.

Generates a seeded Poisson workload (mixed prompt / output lengths, a
greedy / sampled mix), replays it through
:class:`repro_torch.serve.ServeEngine` on a virtual clock
(:func:`repro_torch.serve.drive`) and prints the serving headline metrics.
``--pressure`` undersizes the page pool so that growing sequences preempt
the youngest one (evicted, requeued, re-prefilled with prompt and generated
tokens, its stream resumed exactly); the run asserts that it happened.

At the reference's settings the geometry and workload are the reference's:
the arch's smoke reduction, ``max_len`` 96, pages of 8 tokens, prefill
chunks of 16, prompts of 4-40 and outputs of 8-48 tokens, a pressured pool
of ``1 + slots * 4`` pages.  ``--full`` serves the arch's published widths
at the card's geometry (``max_len`` 512, pages of 16, chunks of 64, prompts
of 32-384 and outputs of 16-128 tokens, a pressured pool of
``1 + slots * 12`` pages: 97 at 8 slots); ``--layers N`` cuts the depth.

Weights are random, drawn from seed 0 on the device.  Without a stop token
the schedule (steps, preemptions, chunks, each request's preemptions)
depends only on the requests' lengths and arrivals, never on token values.

Usage (on the card, or on the CPU with ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.serve_traffic --device cpu --pressure
  PYTHONPATH=src python -m repro_torch.launch.serve_traffic --full --pressure
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.launch.serve_lm import build_config, init_params
from repro_torch.models.types import ModelConfig
from repro_torch.serve import ServeEngine, drive, poisson_workload
from repro_torch.serve.metrics import percentile, summarize_ms

SECONDS_PER_STEP = 1e-3           # the virtual clock's advance per step


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The engine's cache geometry and the workload's request lengths
    (inclusive ranges); ``--pressure`` gives ``pages_per_slot`` pages a
    slot."""
    max_len: int
    page_size: int
    prefill_chunk: int
    prompt_len: tuple
    out_len: tuple
    pages_per_slot: int


REFERENCE = Geometry(max_len=96, page_size=8, prefill_chunk=16,
                     prompt_len=(4, 40), out_len=(8, 48), pages_per_slot=4)
FULL = Geometry(max_len=512, page_size=16, prefill_chunk=64,
                prompt_len=(32, 384), out_len=(16, 128), pages_per_slot=12)


def workload(cfg: ModelConfig, geometry: Geometry, *, requests: int = 32,
             rate: float = 500.0, seed: int = 7) -> list:
    """The seeded Poisson request schedule at ``geometry``'s lengths."""
    return poisson_workload(requests, rate_rps=rate, seed=seed,
                            vocab_size=cfg.vocab_size,
                            prompt_len=geometry.prompt_len,
                            out_len=geometry.out_len)


def pressure_pages(geometry: Geometry, slots: int) -> int:
    """The undersized pool of ``--pressure`` (the null page included)."""
    return 1 + slots * geometry.pages_per_slot


def run_traffic(cfg: ModelConfig, params, specs, geometry: Geometry, *,
                slots: int = 8, n_pages: int | None = None,
                capture_logits: bool = False, device=None) -> dict:
    """Replay ``specs`` through a fresh engine (on the card when ``device``
    is None) and check that every page came back.  Returns the requests,
    ``drive``'s summary, ``eng.metrics.summary()``, the virtual TTFT and
    ITL summaries (ms) and the wall ms of each decode step and prefill
    chunk, the device synchronised after each."""
    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    eng = ServeEngine(cfg, params, slots=slots, max_len=geometry.max_len,
                      page_size=geometry.page_size,
                      prefill_chunk=geometry.prefill_chunk, n_pages=n_pages,
                      capture_logits=capture_logits, device=device)
    step_ms = {"decode": [], "prefill": []}
    engine_step = eng.step

    def timed_step() -> bool:
        # ``drive`` owns the engine's clock; the wall is timed here
        decode_steps = eng.metrics.decode_steps
        t0 = time.perf_counter()
        did = engine_step()
        sync()
        if did:
            kind = ("decode" if eng.metrics.decode_steps > decode_steps
                    else "prefill")
            step_ms[kind].append((time.perf_counter() - t0) * 1e3)
        return did

    eng.step = timed_step
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            res = drive(eng, specs, seconds_per_step=SECONDS_PER_STEP)
            sync()
            wall = time.perf_counter() - t0
    finally:
        del eng.step
    eng.assert_no_leaks()
    reqs = res["requests"]
    done = [r for r in reqs if r.state.value == "finished"]
    return {
        "requests": reqs,
        "drive": {"steps": res["steps"],
                  "backpressured": res["backpressured"]},
        "metrics": eng.metrics.summary(),
        "ttft_ms": summarize_ms([r.metrics.ttft for r in done
                                 if r.metrics.ttft is not None]),
        "itl_ms": summarize_ms([i for r in done for i in r.metrics.itls]),
        "step_ms": step_ms,
        "wall_s": wall,
    }


def schedule(out: dict) -> dict:
    """What the engine did, independent of token values: drive steps,
    backpressure, the step mix, preemptions and each request's preemptions
    and output length."""
    m = out["metrics"]
    return {"steps": out["drive"]["steps"],
            "backpressured": out["drive"]["backpressured"],
            "decode_steps": m["decode_steps"],
            "prefill_chunks": m["prefill_chunks"],
            "preemptions": m["preemptions"],
            "tokens": m["tokens_sampled"],
            "requests": [(r.preemptions, len(r.out_tokens))
                         for r in out["requests"]]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=registry.list_archs())
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="arrival rate (requests per virtual second)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--pressure", action="store_true",
                    help="undersize the page pool to force preemptions")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths at the card's "
                         "geometry, not the smoke size")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers")
    args = ap.parse_args(argv)
    cfg = build_config(args.arch, args.full, args.layers)
    device = resolve_device(args.device)
    geometry = FULL if args.full else REFERENCE
    n_pages = pressure_pages(geometry, args.slots) if args.pressure else None
    specs = workload(cfg, geometry, requests=args.requests, rate=args.rate,
                     seed=args.seed)
    out = run_traffic(cfg, init_params(cfg, device), specs, geometry,
                      slots=args.slots, n_pages=n_pages, device=device)
    done = [r for r in out["requests"] if r.state.value == "finished"]
    m, ttft, itl = out["metrics"], out["ttft_ms"], out["itl_ms"]
    print(f"arch={cfg.name} slots={args.slots} "
          f"requests={args.requests} completed={len(done)} "
          f"steps={out['drive']['steps']} "
          f"backpressured={out['drive']['backpressured']}")
    print(f"tokens={m['tokens_sampled']} occupancy={m['occupancy_mean']:.0%} "
          f"peak_in_flight={m['peak_in_flight']} "
          f"preemptions={m['preemptions']} page_leaks=0")
    print(f"virtual ttft p50/p99 = {ttft['p50']:.1f}/{ttft['p99']:.1f} ms, "
          f"itl p50/p99 = {itl['p50']:.1f}/{itl['p99']:.1f} ms")
    if args.pressure:
        if m["preemptions"] == 0:
            raise AssertionError("expected preemption under pressure")
        print("pressure run: preempted sequences re-prefilled and completed")
    ms = out["step_ms"]
    print(f"wall {out['wall_s']:.3f} s on {device}: "
          f"{m['tokens_sampled'] / out['wall_s']:.1f} tokens/s; "
          f"decode step ms p50/p99 = {percentile(ms['decode'], 50):.3f}/"
          f"{percentile(ms['decode'], 99):.3f}, prefill chunk ms p50/p99 = "
          f"{percentile(ms['prefill'], 50):.3f}/"
          f"{percentile(ms['prefill'], 99):.3f}")
    return out


if __name__ == "__main__":
    main()
