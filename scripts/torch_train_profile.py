"""Where a training step's time goes in the PyTorch port, on one CUDA card.

    python3 scripts/torch_train_profile.py

Trains full-width qwen2-1.5b (random bfloat16 weights from seed 0) at the
shape of ``chip_smoke.py`` phase 9 (B 4 x S 4,096, AdamW from
``make_optimizer``), warms with 2 steps and traces one with
``torch.profiler``.  Prints the step's wall time, the device's busy share
(kernel time summed over the traced wall time, one stream), the device
time by kernel name, and the device time under each autograd node of the
backward (``_BlockedAttentionBackward`` is blocked attention's plain
PyTorch backward).  The profiler slows the host; the device times are what
to read.  Imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

B, S, WARM = 4, 4_096, 2


def device_us(evt, self_only: bool = True) -> float:
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    return next((getattr(evt, n) for n in names if hasattr(evt, n)), 0.0)


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
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import steps, train_lm
    from repro_torch.models import api
    from repro_torch.models.types import ShapeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get("qwen2-1.5b")
    opt = steps.make_optimizer(cfg)
    state = train_lm.init_state(cfg, opt, "cuda", seed=0)
    shape = ShapeConfig("train_4k", "train", S, B)
    batches = [api.batch_to(synthetic_batch(cfg, shape, 0, i), "cuda")
               for i in range(WARM + 1)]
    for batch in batches[:WARM]:
        state, _ = steps.train_step(state, batch, cfg, opt, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, metrics = steps.train_step(state, batches[-1], cfg, opt,
                                          device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    averages = prof.key_averages()
    kernels = sorted((e for e in averages
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and device_us(e) > 0), key=device_us, reverse=True)
    total_ms = sum(device_us(e) for e in kernels) / 1e3
    print(card_line())
    print(f"one traced step of {cfg.name} at B {B} x S {S} (loss "
          f"{metrics['loss'].item():.4f}): wall {wall_ms:.1f} ms; device "
          f"busy {total_ms:.1f} ms = {100 * total_ms / wall_ms:.1f}%; "
          f"{sum(e.count for e in kernels)} kernel launches")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in kernels[:25]:
        ms = device_us(e) / 1e3
        print(f"{ms:10.2f} {100 * ms / total_ms:5.1f}% {e.count:6d}  "
              f"{e.key[:100]}")
    nodes = sorted((e for e in averages
                    if e.key.startswith("autograd::engine::evaluate_function")
                    and device_us(e, self_only=False) > 0),
                   key=lambda e: device_us(e, self_only=False), reverse=True)
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  backward node "
          f"(device time of its kernels)")
    for e in nodes[:12]:
        ms = device_us(e, self_only=False) / 1e3
        print(f"{ms:10.2f} {100 * ms / total_ms:5.1f}% {e.count:6d}  "
              f"{e.key.split(': ', 1)[-1][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
