"""End-to-end training driver on one device: the twin of the JAX package's
``examples/train_lm.py`` — train step, runahead data loader, async
checkpointing, straggler watchdog, crash recovery.

Usage (full width on the card, or the reference's ~100M shape on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 20 --batch 4 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu --reduced \\
      --steps 20 --batch 2 --seq 64

The pieces (:func:`build_config`, :func:`init_state`, :func:`make_loader`,
:func:`make_driver`) are what ``chip_smoke.py`` drives on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.data.pipeline import RunaheadLoader, device_put, synthetic_batch
from repro_torch.launch.steps import make_optimizer, train_step
from repro_torch.models import api, lm
from repro_torch.models.types import ModelConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import StragglerWatchdog, TrainDriver


def build_config(arch: str, reduced: bool) -> ModelConfig:
    cfg = registry.get(arch)
    if reduced:
        # ~100M params: 12L x 768 with the arch's own family structure
        cfg = dataclasses.replace(
            cfg, name=cfg.name + "-100m", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
            vocab_size=32_000, accum_steps=1)
    return cfg


def init_state(cfg: ModelConfig, opt: adamw.AdamWConfig, device,
               seed: int = 0) -> dict:
    """Random N(0, 0.02) weights drawn on ``device`` from ``seed``, and
    zero AdamW moments."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return adamw.init_state(api.init_params(cfg, gen, device), opt)


def make_loader(cfg: ModelConfig, shape: ShapeConfig, device, *,
                seed: int = 0, depth: int = 2) -> RunaheadLoader:
    return RunaheadLoader(
        lambda step: synthetic_batch(cfg, shape, seed=seed, step=step),
        put_fn=device_put(device), depth=depth)


def make_driver(cfg: ModelConfig, opt: adamw.AdamWConfig,
                loader: RunaheadLoader, ckpt_dir, device, *,
                checkpoint_every: int = 50,
                watchdog: StragglerWatchdog | None = None) -> TrainDriver:
    step_fn = functools.partial(train_step, cfg=cfg, opt=opt, device=device)
    return TrainDriver(step_fn, loader.get, Checkpointer(ckpt_dir),
                       checkpoint_every=checkpoint_every, watchdog=watchdog)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b",
                    choices=registry.list_archs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference example's ~100M shape (CPU runs)")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = build_config(args.arch, args.reduced)
    shape = ShapeConfig("train_custom", "train", args.seq, args.batch)
    opt = make_optimizer(cfg)
    state = init_state(cfg, opt, device)
    print(f"arch={cfg.name} params={lm.param_count(state['params'])/1e6:.1f}M"
          f" device={device}")
    loader = make_loader(cfg, shape, device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    wd = StragglerWatchdog(on_straggler=lambda s, t, m: print(
        f"  [watchdog] step {s}: {t:.2f}s vs median {m:.2f}s"))
    driver = make_driver(cfg, opt, loader, ckpt_dir, device,
                         checkpoint_every=args.checkpoint_every, watchdog=wd)
    t0 = time.time()
    state, hist = driver.run(state, args.steps)
    dt = time.time() - t0
    loader.close()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"steps={len(hist)} loss {first:.3f} -> {last:.3f} "
          f"({dt/len(hist)*1e3:.0f} ms/step) "
          f"ckpts={driver.checkpointer.all_steps()} dir={ckpt_dir}")
    return hist


if __name__ == "__main__":
    main()
