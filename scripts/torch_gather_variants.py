"""Both routes of the runahead gather, an older kernel and ``index_select``
on one CUDA card: the evidence for ``gather_runahead.route``.

    python3 scripts/torch_gather_variants.py [--parent PATH]

For rows of 512 B (``chip_smoke.py`` phase 7's float32 ``graph`` stream:
1,166,240 rows of the OGBN-Arxiv-shaped table), 2,048 B (262,144 uniform
rows of a 169,343 x 512 float32 table), 12,288 B (phase 15's gather:
8 x 4,096 seeded tokens of dbrx-132b's 100,352 x 6,144 bfloat16
embedding) and 14,528 B (40,000 uniform rows of a 100,000 x 3,632 float32
table: 16 one-row tiles fill a block's shared memory, so the deepest ring
leaves no room for the bulk route's barriers), at block_rows 1 and 8 and
depths 1, 2, 4, 8, 15 and 16 where the ring fits a block's shared memory,
it times each route of
``csrc/gather_runahead.cu`` (``runahead_gather(..., use=...)``) and, with
``--parent PATH``, the kernel source at PATH (the C interface before the
routes: ``runahead_gather_launch`` without its route argument), e.g.
``git show <commit>:src/repro_torch/kernels/gather_runahead/csrc/gather_runahead.cu
> build/dev/gather_parent.cu`` made before the call, since the chip's copy
has no ``.git``.  Times are CUDA-graph replays with the L2 overwritten
before each call (``chip_smoke.graph_ms``); the kernels of one shape are
timed in turns (parent, bulk, cp_async, then back) and each ms is the
mean of its two turns.  ``index_select`` is timed once a row size, before
and after its shapes.  Every output must equal ``table[idx]`` bit for bit.
Prints the bytes bound (each distinct row read once, the indices, the
output) and the card.  Builds into ``build/`` beside the checkout's other
builds.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gather_runahead import (  # noqa: E402
    gather_runahead as kernel)

DEV = ROOT / "build" / "dev"
DEPTHS = (1, 2, 4, 8, 15, 16)
BLOCK_ROWS = (1, 8)
# the parent's runahead_gather_launch(table, idx, out, n_tiles, block_rows,
# row_bytes, depth, grid_blocks, stream)
PARENT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def cases() -> list[tuple[str, torch.Tensor, torch.Tensor]]:
    """(name, table, idx) for each row size, made on the card from seeds."""
    inp = cs.runahead_inputs()
    arxiv = inp["tables"][torch.float32]
    gen = torch.Generator(device="cuda").manual_seed(1)
    wide = torch.randn(cs.ARXIV_NODES, 512, generator=gen, device="cuda")
    uniform = torch.from_numpy(np.random.default_rng(2).integers(
        0, cs.ARXIV_NODES, 262_144).astype(np.int32)).cuda()
    vocab, d = 100_352, 6_144                  # dbrx-132b's embedding
    embed = torch.randn(vocab, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (cs.ALLOC_B, cs.ALLOC_S)).astype(np.int32)).cuda()
    fits = kernel.MAX_SMEM_BYTES // (16 * 4)     # 3,632 float32: 14,528 B
    full = torch.randn(100_000, fits, generator=gen, device="cuda")
    rows = torch.from_numpy(np.random.default_rng(3).integers(
        0, 100_000, 40_000).astype(np.int32)).cuda()
    return [("512 B (phase 7, f32 graph)", arxiv, inp["streams"]["graph"]),
            ("2,048 B (uniform)", wide, uniform),
            ("12,288 B (phase 15's plan)", embed, tokens.reshape(-1)),
            ("14,528 B (rings up to the shared-memory limit)", full, rows)]


def build_parent(path: Path) -> subprocess.Popen:
    DEV.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(DEV / "gather_parent.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gather_variants: no CUDA device", file=sys.stderr)
        return 1
    proc = build_parent(args.parent) if args.parent else None
    _build.build(["gather_runahead"])
    parent = None
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent:\n{log}")
        parent = ctypes.CDLL(str(DEV / "gather_parent.so"))
        parent.runahead_gather_launch.argtypes = PARENT_ARGS
        parent.runahead_gather_launch.restype = ctypes.c_int

    card = cs.card_line()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    bad = []
    for name, table, idx in cases():
        n = idx.shape[0]
        row = table.shape[1] * table.element_size()
        distinct = torch.unique(idx).numel()
        n_bytes = distinct * row + n * 4 + n * row
        want = table[idx.long()]

        def library():
            return torch.index_select(table, 0, idx)

        lib_ms = [cs.graph_ms(library, flush)]
        print(f"rows of {name}: n={n} distinct {distinct} bound_ms="
              f"{n_bytes / cs.MEM_BYTES_PER_S * 1e3:.4f} ({n_bytes} bytes)",
              flush=True)
        for block_rows in BLOCK_ROWS:
            for depth in DEPTHS:
                if depth * block_rows * row > kernel.MAX_SMEM_BYTES:
                    continue
                runs = {}
                if parent is not None:
                    def run_parent(depth=depth, block_rows=block_rows):
                        out = torch.empty_like(want)
                        err = parent.runahead_gather_launch(
                            table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                            n // block_rows, block_rows, row, depth, 0,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"parent: CUDA error {err}")
                        return out
                    runs["parent"] = run_parent
                for use in ("bulk", "cp_async"):
                    if use == "bulk" and not kernel.bulk_fits(
                            row, block_rows, depth):
                        continue
                    runs[use] = (lambda use=use, depth=depth,
                                 block_rows=block_rows:
                                 kernel.runahead_gather(
                                     table, idx, block_rows=block_rows,
                                     depth=depth, use=use))
                for who, fn in runs.items():
                    if not cs.bit_equal(fn(), want):
                        bad.append(f"{name} {who} block_rows {block_rows} "
                                   f"depth {depth}")
                order = list(runs) + list(runs)[::-1]
                times = {who: [] for who in runs}
                for who in order:
                    times[who].append(cs.graph_ms(runs[who], flush))
                ms = {who: round(statistics.mean(t), 4)
                      for who, t in times.items()}
                print(f"  block_rows {block_rows} depth {depth:2d}: ms "
                      f"{ms} (turns {times}); route() "
                      f"{kernel.route(row, block_rows, depth)}", flush=True)
        lib_ms.append(cs.graph_ms(library, flush))
        print(f"  index_select ms {[round(t, 4) for t in lib_ms]} (before, "
              f"after); {card}", flush=True)
        del want
        torch.cuda.empty_cache()
    print(card)
    if bad:
        print(f"not bit-identical to table[idx]: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
