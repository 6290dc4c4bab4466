"""Serving example: the twin of the JAX package's ``examples/serve_lm.py``.

The default path submits a handful of mixed-length requests to
:class:`repro_torch.serve.ServeEngine` (chunked prefill, slot-batched
decode, per-request temperatures, optional streamed tokens) and prints
each request's stream and the engine metrics; it serves any arch that
``api.serve_supported`` accepts (dense and MoE attention decoders).
``--legacy`` runs the lockstep batch loop instead (every sequence at one
shared position, greedy tokens), ``api.init_cache`` / ``api.decode``: the
path that serves the SSM and hybrid archs.  The encoder-decoder arch
(whisper-small) is refused in both modes: its decode needs the encoder's
cross K/V, which ``chip_smoke.py`` phase 14 makes.  It has no mesh (the
reference's sharded serve step is a later slice of the port).

Weights are random, drawn from seed 0 on the device.  The arch's smoke
reduction runs unless ``--full`` asks for its published widths;
``--layers N`` cuts the depth.

Usage (on the card, or on the CPU with ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen2-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch dbrx-132b --full --layers 8
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mamba2-2.7b --legacy --tokens 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.models.types import ModelConfig


def build_config(arch: str, full: bool, layers: int | None) -> ModelConfig:
    cfg = registry.get(arch) if full else registry.smoke(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def init_params(cfg: ModelConfig, device):
    gen = torch.Generator(device=device).manual_seed(0)
    return api.init_params(cfg, gen, device)


def run_engine(args, cfg: ModelConfig, device) -> dict:
    from repro_torch.serve import ServeEngine

    ok, why = api.serve_supported(cfg)
    if not ok:
        raise SystemExit(f"{cfg.name}: {why} (use --legacy)")
    eng = ServeEngine(cfg, init_params(cfg, device), slots=args.batch,
                      max_len=args.cache_len, page_size=16, prefill_chunk=16,
                      backend=args.backend, device=device)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.batch + 2):          # more requests than slots
        plen = int(rng.integers(2, 24))
        reqs.append(eng.submit(
            rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=args.tokens,
            temperature=0.8 if i % 2 else 0.0, seed=i,
            stream_cb=(lambda tok, r: print(
                f"  r{r.rid} -> {tok}", flush=True)) if args.stream else None))
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    eng.assert_no_leaks()
    for r in reqs:
        print(f"r{r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens[:10]}"
              f"{'...' if len(r.out_tokens) > 10 else ''} "
              f"({r.done_reason()}, ttft {r.metrics.ttft * 1e3:.0f} ms)")
    m = eng.metrics.summary()
    print(f"arch={cfg.name} backend={args.backend} device={device} "
          f"{m['tokens_sampled']} tokens in {dt:.1f}s "
          f"({m['tokens_sampled'] / dt:.0f} tok/s), "
          f"occupancy {m['occupancy_mean']:.0%}, "
          f"steps {m['steps']} ({m['prefill_chunks']} prefill chunks)")
    return {"streams": [r.out_tokens for r in reqs], "metrics": m}


def run_legacy(args, cfg: ModelConfig, device) -> dict:
    params = init_params(cfg, device)
    cache = api.init_cache(cfg, args.batch, args.cache_len, device=device)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (args.batch, 1)),
                             dtype=torch.int32, device=device)
    generated = [tokens]
    t0 = time.time()
    for _ in range(args.tokens):
        logits, cache = api.decode(params, tokens, cache, cfg)
        tokens = logits.argmax(dim=-1).to(torch.int32)[:, None]
        generated.append(tokens)
    seqs = torch.cat(generated, dim=1).cpu().numpy()
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} device={device} generated "
          f"{args.tokens} tokens/seq in {dt:.1f}s "
          f"({dt / max(1, args.tokens) * 1e3:.0f} ms/token)")
    print("first sequence:", seqs[0][:16], "...")
    assert seqs.shape == (args.batch, args.tokens + 1)
    assert cache["pos"] == args.tokens
    return {"sequences": seqs, "pos": cache["pos"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=registry.list_archs())
    ap.add_argument("--batch", type=int, default=8,
                    help="decode slots (engine) / batch size (--legacy)")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--backend", default="paged", choices=("paged", "dense"))
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they stream (engine mode)")
    ap.add_argument("--legacy", action="store_true",
                    help="the lockstep batch loop instead of the engine")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths, not its smoke size")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers")
    args = ap.parse_args(argv)
    cfg = build_config(args.arch, args.full, args.layers)
    if cfg.family == "encdec":
        raise SystemExit(
            f"{cfg.name}: an encoder-decoder decodes against its encoder "
            f"output's cross K/V (encdec.encode, encdec.precompute_cross, "
            f"then api.decode), which this example does not make; "
            f"chip_smoke.py phase 14 serves it that way")
    device = resolve_device(args.device)
    with torch.no_grad():
        if args.legacy:
            return run_legacy(args, cfg, device)
        return run_engine(args, cfg, device)


if __name__ == "__main__":
    main()
