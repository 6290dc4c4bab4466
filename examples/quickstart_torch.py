"""Quickstart on the PyTorch port: the paper's mechanism in 60 seconds.

1. Run a GCN aggregation kernel through the cycle-level CGRA simulator in
   three memory-system configurations (SPM-only / Cache+SPM / +Runahead).
2. Reconfigure the multi-cache system with Algorithm 1, its profile on
   the card's cache-grid kernel.
3. Run the accelerator analogue: the runahead gather kernel at depth 4.

The twin of ``examples/quickstart.py``; it prints the same numbers.

Usage:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the CUDA card when ``--device`` is omitted)
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cgra import presets, simulate
from repro_torch.core.cgra.reconfig import reconfigure
from repro_torch.core.cgra.trace import gcn_aggregate
from repro_torch.kernels.gather_runahead import ops as gather_ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    device = resolve_device(ap.parse_args(argv).device)

    print("== 1. CGRA memory-subsystem simulation (GCN aggregate, Cora) ==")
    tr = gcn_aggregate("cora")
    spm = simulate(tr, presets.SPM_ONLY_4K)
    cache = simulate(tr, presets.CACHE_SPM)
    ra = simulate(tr, presets.RUNAHEAD)
    print(f" SPM-only(4K) : {spm.cycles:>9} cycles  util={spm.utilization:.2%}")
    print(f" Cache+SPM    : {cache.cycles:>9} cycles  "
          f"speedup={spm.cycles/cache.cycles:.2f}x  "
          f"L1 hit rate={cache.l1_hit_rate:.1%}")
    print(f" +Runahead    : {ra.cycles:>9} cycles  "
          f"speedup={cache.cycles/ra.cycles:.2f}x  "
          f"coverage={ra.coverage:.0%}  accuracy={ra.prefetch_accuracy:.0%}")

    print("\n== 2. Algorithm-1 cache reconfiguration (8x8 multi-cache) ==")
    res = reconfigure(tr, presets.RECONFIG, window=8192, device=device)
    base = simulate(tr, presets.RECONFIG)
    new = simulate(tr, res.config)
    print(f" way allocation: {res.allocations}  line sizes: {res.lines}")
    print(f" cycles {base.cycles} -> {new.cycles} "
          f"({(base.cycles-new.cycles)/base.cycles:+.2%})")

    print(f"\n== 3. Accelerator analogue: runahead gather ({device}) ==")
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(1024, 128)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 1024, 64).astype(np.int32))
    out = gather_ops.gather(table.to(device), idx.to(device),
                            impl="runahead", depth=4)
    ok = bool(torch.equal(out.cpu(), table[idx.long()]))
    print(f" runahead_gather(depth=4): {tuple(out.shape)} correct={ok}")


if __name__ == "__main__":
    main()
