"""Algorithm-1 as an on-chip-memory budget allocator for kernel operand
streams (the twin of ``repro.core.runahead.vmem_allocator``).

The paper's reconfiguration loop (§3.4) — sample per-PE access streams,
model hit rates, DP-allocate cache ways, tune line sizes — maps onto
kernel tuning:

  cache ways   -> on-chip tile units per operand stream (the reference's
                  VMEM tiles; shared memory on the card)
  line size    -> fetch granularity (bytes per async copy)
  hit rate     -> staged-row reuse fraction under that budget
  Time HitRate -> all streams must hit per step (lock-step == the pipeline)

``allocate`` profiles the traced index streams with the cache-grid model
(:func:`repro_torch.core.cgra.reconfig.profile_curves`, on the card by
default) and returns per-stream (tiles, dma_bytes) plus the suggested
runahead-gather ring depth (the MSHR analogue), which
``kernels.gather_runahead.ops.gather`` takes for every value it can have.
The plan is the reference's for the same streams.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cgra.reconfig import algorithm1, profile_curves

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    name: str
    tiles: int             # on-chip tile units granted
    bytes: int             # tiles * tile_bytes
    dma_bytes: int         # chosen fetch granularity ("line size")
    hit_rate: float        # modeled reuse under this budget


@dataclasses.dataclass(frozen=True)
class VmemPlan:
    streams: list[StreamPlan]
    depth: int             # runahead window (copies in flight)
    total_profit: float


def allocate(streams: dict[str, np.ndarray], *, budget_tiles: int = 16,
             tile_bytes: int = 32 * 1024,
             dma_options=(256, 512, 1024, 2048),
             row_bytes: dict[str, int] | None = None,
             device=None) -> VmemPlan:
    """streams: name -> index array (row ids, in access order); the
    profile runs on ``device`` (CUDA when None)."""
    names = list(streams)
    row_bytes = row_bytes or {}
    profiled = []
    for name in names:
        idx = np.asarray(streams[name], dtype=np.int64)
        stride = int(row_bytes.get(name, 256))
        profiled.append((idx * stride, np.arange(idx.size)))
    h = profile_curves(profiled, list(range(budget_tiles + 1)),
                       list(dma_options), tile_bytes, device=device)
    H = h.max(axis=2)
    profit = np.log(np.maximum(H, EPS))
    total, alloc = algorithm1(profit, budget_tiles)
    plans = []
    for i, name in enumerate(names):
        line = int(dma_options[int(h[i, alloc[i]].argmax())])
        plans.append(StreamPlan(name, alloc[i], alloc[i] * tile_bytes, line,
                                float(H[i, alloc[i]])))
    depth = max(2, min(16, max(a for a in alloc) or 2))
    return VmemPlan(plans, depth, float(total))
