"""Row gathers, dispatched on the operands' device.

The twin of the JAX package's ``kernels/gather_runahead/ops.py``, without
``interpret``.  A CPU tensor takes the plain PyTorch version (``ref.py``);
a CUDA tensor launches the hand-written kernel (``gather_runahead.py``),
which raises if it cannot build or launch.  There is no fallback from one
to the other.
"""
from __future__ import annotations

from . import gather_runahead as kernel
from . import ref

IMPLS = ("runahead", "pipelined", "reference")


def gather(table, idx, *, impl: str = "runahead", block_rows: int = 8,
           depth: int = 2):
    """out[i] = table[idx[i]].

    impl: "runahead" (a ring of ``depth`` index blocks of ``block_rows``
    rows in flight; ``depth``, in 1..16, is the MSHR analogue),
    "pipelined" (one row per warp, the baseline), or "reference" (the
    plain version, on any device).
    """
    if impl not in IMPLS:
        raise ValueError(f"gather: impl={impl!r} not in {IMPLS}")
    if impl == "reference" or table.device.type == "cpu":
        if impl == "runahead":     # the kernel's contract, on any device
            if idx.shape[0] % block_rows:
                raise ValueError(f"runahead_gather: n={idx.shape[0]} is not "
                                 f"a multiple of block_rows={block_rows}")
            kernel.check_depth("runahead_gather", depth, 1,
                               kernel.MAX_RUNAHEAD_DEPTH)
        return ref.gather_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather: no kernel for device {table.device}")
    if impl == "pipelined":
        return kernel.pipelined_gather(table, idx)
    return kernel.runahead_gather(table, idx, block_rows=block_rows,
                                  depth=depth)


def gather_bag(table, idx, weights, *, depth: int = 2):
    """Listing-1 aggregation: out[s] = sum_k w[s,k] * table[idx[s,k]], the
    weights taken to float32 as the reference's kernel takes them."""
    if table.device.type == "cpu":
        return ref.gather_bag_ref(table, idx, weights)
    if table.device.type != "cuda":
        raise ValueError(f"gather_bag: no kernel for device {table.device}")
    return kernel.gather_bag(table, idx, weights.float(), depth=depth)
