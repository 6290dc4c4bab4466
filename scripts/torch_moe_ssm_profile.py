"""Where the MoE and SSM paths' time goes in the PyTorch port, on one CUDA
card.

    python3 scripts/torch_moe_ssm_profile.py

Two traces with ``torch.profiler``, the shapes of ``chip_smoke.py``
phases 11 and 13 (random bfloat16 weights from seed 0):

* dbrx-132b at full width, 8 of its 40 layers, served through
  ``repro_torch.serve.ServeEngine`` (8 slots, page 16, chunk 64, kernel
  read): all 8 slots filled with prompts of 32-384 tokens, then 10 decode
  steps traced once every slot decodes, and 4 prefill chunks traced;
* mamba2-2.7b at full width and depth: one ``api.prefill`` at B 4 x S
  4,096 traced after a warm-up, and 5 lockstep ``api.decode`` steps of 8
  sequences.

For each it prints the wall time, the device time and launches per step
or call, the device's busy share of the traced window (kernel time summed
over the window's wall time, one stream), and the device time by kernel
name.  The profiler slows the host; the device times are what to read.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

TOP = 12


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def traced(what: str, n: int, fn) -> None:
    """Run ``fn`` n times under the profiler (synchronising after each)
    and print the split."""
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            s0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - s0) * 1e3)
        window_ms = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0
              and not e.key.startswith("serve.")]   # the engine's spans
    events.sort(key=device_us, reverse=True)
    total_ms = sum(device_us(e) for e in events) / 1e3
    print(f"{what}: {n} traced; wall ms each mean {np.mean(walls):.3f} "
          f"(min {min(walls):.3f}, max {max(walls):.3f}); device busy "
          f"{total_ms:.3f} of {window_ms:.3f} ms = "
          f"{100 * total_ms / window_ms:.1f}%; each: "
          f"{sum(e.count for e in events) / n:.1f} kernel launches, "
          f"{total_ms / n:.3f} ms of device time")
    print(f"{'device ms each':>14} {'share':>6} {'calls each':>10}  kernel")
    for e in events[:TOP]:
        ms = device_us(e) / 1e3
        print(f"{ms / n:14.4f} {100 * ms / total_ms:5.1f}% "
              f"{e.count / n:10.1f}  {e.key[:90]}")
    sys.stdout.flush()


def profile_dbrx() -> None:
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import RequestState

    cfg = dataclasses.replace(registry.get("dbrx-132b"), n_layers=8)
    params = api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = ServeEngine(cfg, params, slots=8, max_len=512, page_size=16,
                      prefill_chunk=64, attn_read="kernel")
    rng = np.random.default_rng(0)
    for n in rng.integers(32, 385, size=8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(),
                   max_new_tokens=64)
    for _ in range(3):                           # warm: prefill chunks
        eng.step()
    traced(f"{cfg.name}, 8 layers: prefill chunk of 64 tokens", 4,
           lambda: eng.step())
    while any(r.state is not RequestState.DECODE for r in eng.sched.live()):
        eng.step()
    for _ in range(3):                           # warm, all slots decode
        eng.step()
    traced(f"{cfg.name}, 8 layers: decode step of 8 slots", 10,
           lambda: eng.step())


def profile_mamba() -> None:
    from repro_torch.configs import registry
    from repro_torch.models import api

    cfg = registry.get("mamba2-2.7b")
    params = api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {"tokens": np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 4096))}
    with torch.no_grad():
        api.prefill(params, batch, cfg, device="cuda")
        traced(f"{cfg.name}: prefill B 4 x S 4096", 1,
               lambda: api.prefill(params, batch, cfg, device="cuda"))
        cache = api.init_cache(cfg, 8, 256)
        tok = np.ones((8, 1), np.int32)
        for _ in range(3):
            api.decode(params, tok, cache, cfg)
        traced(f"{cfg.name}: lockstep decode step of 8 sequences", 5,
               lambda: api.decode(params, tok, cache, cfg))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    profile_dbrx()
    torch.cuda.empty_cache()
    profile_mamba()
    return 0


if __name__ == "__main__":
    sys.exit(main())
