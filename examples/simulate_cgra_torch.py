"""Reproduce the paper's headline numbers from the command line, on the
PyTorch port.

The twin of ``examples/simulate_cgra.py``; it prints the same numbers.  The
simulator runs on the host; the §3.4 reconfiguration's profile runs on
``--device`` (the CUDA card when omitted).

Usage:  PYTHONPATH=src python examples/simulate_cgra_torch.py \\
            [--kernel gcn_cora] [--device cpu]
"""
import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.core.cgra import KERNELS, presets, simulate
from repro_torch.core.cgra.reconfig import reconfigure


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="gcn_cora", choices=sorted(KERNELS))
    ap.add_argument("--device", default=None,
                    help="torch device of the profile; the CUDA card when "
                         "omitted")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tr = KERNELS[args.kernel]()
    print(f"kernel={tr.name}: {len(tr)} accesses, "
          f"{tr.irregular_fraction:.0%} irregular, "
          f"{tr.footprint()//1024} KiB footprint, II={tr.ii}")
    rows = [
        ("SPM-only 4K (Fig.2)", presets.SPM_ONLY_4K),
        ("SPM-only 133K", presets.SPM_ONLY_133K),
        ("Cache+SPM (Table 3)", presets.CACHE_SPM),
        ("+Runahead", presets.RUNAHEAD),
        ("8x8 multi-cache", presets.RECONFIG),
        ("8x8 + runahead", dataclasses.replace(presets.RECONFIG,
                                               runahead=True)),
    ]
    base_cycles = None
    for name, cfg in rows:
        s = simulate(tr, cfg)
        base_cycles = base_cycles or s.cycles
        print(f" {name:22s} {s.cycles:>10} cycles  util={s.utilization:6.2%}"
              f"  hit={s.l1_hit_rate:5.1%}  cov={s.coverage:4.0%}")
    res = reconfigure(tr, presets.RECONFIG, window=8192, device=device)
    s = simulate(tr, dataclasses.replace(res.config, runahead=True))
    print(f" {'reconfig + runahead':22s} {s.cycles:>10} cycles  "
          f"alloc={res.allocations} lines={res.lines}")


if __name__ == "__main__":
    main()
