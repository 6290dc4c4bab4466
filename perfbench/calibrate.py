"""Readings for a cell's limit: the program's and the control's, over many
seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --seconds <s>

Each seed is one run of the cell as ``run.py`` makes it (the cell's own
traffic, engine and sizes; the window may be shorter), after which the
judged sample is read twice: by the float32 reference (the program's
``max_logit_gap``, ``mean_logit_gap`` and ``per_request``: each judged
request's tokens and the sum of their gaps, from which a limits file's
``max_request_mean_gap`` is read) and by the float8 reference put in the
program's place (the same, prefixed ``control_``).  One JSON line a
seed.  The benchmark's own runs never run the control.
"""
import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from perfbench.run import run_cell
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = run_cell(ROOT, args.workload, seed, args.seconds, False,
                     torch.device("cuda"), t, control=True)
        r["seed"], r["call_s"] = seed, time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
