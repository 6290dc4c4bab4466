"""Memory-access-pattern-aware kernel tuning with Algorithm 1 (§3.4 -> the
card), on the PyTorch port.

The paper's closed loop — sample access streams, model hit rates, DP-allocate
cache ways — becomes an on-chip-memory budget allocator for kernel operand
streams:

1. trace the irregular index streams of a workload (here: MoE routing + the
   vocab-embedding gathers of a batch),
2. model per-stream reuse with the cache-grid model on the card
   (``h_i(line, ways)`` where "ways" = on-chip tile units and "line" =
   fetch granularity),
3. run Algorithm 1 to split a byte budget across the streams,
4. emit the runahead-gather kernel parameters (rows per fetch, ring depth).

The twin of ``examples/autotune_vmem.py``: the same steps on the port's
smoke dbrx-132b; with the reference's weights it prints the reference's
numbers.

Usage:  PYTHONPATH=src python examples/autotune_vmem_torch.py [--device cpu]
(the CUDA card when ``--device`` is omitted)
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.cgra.reconfig import algorithm1, profile_curves
from repro_torch.models import api, moe


def tune(cfg, params, tokens: np.ndarray, device) -> None:
    """Steps 1-4 on ``params`` (an LM of ``cfg``) and tokens [B, S]."""
    # 1. sample the irregular index streams of this workload
    t = torch.as_tensor(tokens, dtype=torch.long, device=params.embed.device)
    with torch.no_grad():
        x = params.embed[t]
        routing = moe.routing_trace(params.blocks[0].moe, x, cfg)
    routing = routing.cpu().numpy().reshape(-1)
    vocab_stream = np.asarray(tokens).reshape(-1)
    d_bytes = cfg.d_model * 2                       # bf16 rows
    streams = [
        (vocab_stream.astype(np.int64) * d_bytes,
         np.arange(vocab_stream.size)),             # embedding gathers
        (routing.astype(np.int64) * cfg.d_ff * 2,
         np.arange(routing.size)),                  # expert-weight touches
    ]
    names = ["vocab_embedding", "moe_expert_rows"]

    # 2. hit-rate curves from the cache-grid model
    budget_units = 16                               # x 32 KiB tiles
    way_bytes = 32 * 1024
    lines = (256, 512, 1024, 2048)                  # bytes per fetch
    h = profile_curves(streams, list(range(budget_units + 1)), lines,
                       way_bytes, device=device)

    # 3. Algorithm 1: allocate tiles to maximize sum(log H_i)
    H = h.max(axis=2)
    profit = np.log(np.maximum(H, 1e-6))
    total, alloc = algorithm1(profit, budget_units)
    best_line = [int(lines[h[i, alloc[i]].argmax()]) for i in range(len(streams))]

    print("stream            VMEM tiles  bytes     DMA line  best hit-rate")
    for i, name in enumerate(names):
        print(f" {name:16s} {alloc[i]:>6d}     {alloc[i]*way_bytes:>8d}"
              f"  {best_line[i]:>7d}B  {H[i, alloc[i]]:.3f}")
    depth = max(2, alloc[1] // 4)
    print(f"\n=> runahead_gather params: block_bytes={best_line[0]}, "
          f"depth={depth}  (depth = MSHR analogue, Fig. 14)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = registry.smoke("dbrx-132b")
    rng = np.random.default_rng(0)
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = rng.integers(0, cfg.vocab_size, (8, 128)).astype(np.int32)
    tune(cfg, params, tokens, device)


if __name__ == "__main__":
    main()
