"""Fig. 15: prefetched-block classification (paper: ~100% accuracy;
evicted blocks concentrate in the high-randomness kernels like grad/rgb).
The twin of ``benchmarks/fig15_accuracy.py``."""
from __future__ import annotations

from repro_torch.core.cgra import presets

from . import common


def points(quick: bool = False) -> list:
    """Sweep axes: every paper kernel under the runahead configuration."""
    return [(name, presets.RUNAHEAD) for name in common.paper_kernels(quick)]


def run(quick: bool = False, device=None) -> dict:
    common.warm(points(quick))
    accs = []
    for name in common.paper_kernels(quick):
        s = common.sim(name, presets.RUNAHEAD)
        tot = max(1, s.prefetch_issued)
        accs.append(s.prefetch_accuracy)
        common.row(
            f"fig15/{name}", 0,
            f"used={s.prefetch_used/tot:.1%};evicted={s.prefetch_evicted/tot:.1%};"
            f"useless={s.prefetch_useless/tot:.1%};accuracy={s.prefetch_accuracy:.1%}",
            cycles=False)
    avg = sum(accs) / len(accs)
    common.row("fig15/avg_accuracy", 0, f"{avg:.1%};paper~100%", cycles=False)
    return {"avg_accuracy": avg}
