"""Where a decode step's time goes in the PyTorch port, on one CUDA card.

    python3 scripts/torch_decode_profile.py

Serves full-width qwen2-1.5b (random bfloat16 weights from seed 0) through
``repro_torch.serve.ServeEngine`` with the engine settings of
``chip_smoke.py`` phase 4, fills all 8 slots with prompts of 32-384 tokens,
and once every slot decodes, traces 10 decode steps with ``torch.profiler``.
Prints the device time by kernel name, the kernel launches and device time
per step, the device's busy share of the traced window (kernel time summed
over the window's wall time, one stream), the host's wall time per step,
which the profiler itself inflates, and the host ms per step of each of
the engine's spans (``serve.step`` and its children).  Imports nothing of
JAX.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

STEPS = 10
SPANS = ("serve.step", "serve.schedule", "serve.sync_cache", "serve.decode",
         "serve.readback", "serve.accept", "serve.account")


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import RequestState

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get("qwen2-1.5b")
    params = api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = ServeEngine(cfg, params, slots=8, max_len=512, page_size=16,
                      prefill_chunk=64, attn_read="kernel")
    rng = np.random.default_rng(0)
    for n in rng.integers(32, 385, size=8):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(),
                   max_new_tokens=64)
    while any(r.state is not RequestState.DECODE for r in eng.sched.live()):
        eng.step()
    for _ in range(3):                              # warm, all slots decode
        eng.step()
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(STEPS):
            s0 = time.monotonic()
            eng.step()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - s0) * 1e3)
        window_ms = (time.monotonic() - t0) * 1e3
    averages = prof.key_averages()
    host_ms = {e.key: e.cpu_time_total / 1e3 / STEPS for e in averages
               if e.key in SPANS and e.device_type
               == torch.autograd.DeviceType.CPU}
    events = [e for e in averages                   # kernels, not aten ops
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0
              and not e.key.startswith("serve.")]   # nor the engine's spans
    events.sort(key=device_us, reverse=True)
    total_ms = sum(device_us(e) for e in events) / 1e3
    print(card_line())
    print(f"{STEPS} decode steps of 8 slots: wall ms per step mean "
          f"{np.mean(walls):.3f} (min {min(walls):.3f}, max "
          f"{max(walls):.3f}); device busy {total_ms:.3f} of "
          f"{window_ms:.3f} ms = {100 * total_ms / window_ms:.1f}% (the "
          f"profiler slows the host; the device time is what to read)")
    print(f"per step: {sum(e.count for e in events) / STEPS:.1f} kernel "
          f"launches, {total_ms / STEPS:.3f} ms of device time")
    print("engine spans, host ms per profiled step: " + ", ".join(
        f"{name} {host_ms.get(name, 0.0):.3f}" for name in SPANS))
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  kernel")
    for e in events[:15]:
        ms = device_us(e) / 1e3
        print(f"{ms / STEPS:14.4f} {100 * ms / total_ms:5.1f}% "
              f"{e.count / STEPS:10.1f}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
