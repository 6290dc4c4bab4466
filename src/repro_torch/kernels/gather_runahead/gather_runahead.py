"""Wrappers of the CUDA row-gather kernels (``csrc/gather_runahead.cu``).

Each wrapper checks its operands, allocates the output, launches on
PyTorch's current stream without synchronising, and raises if the launch
is refused.  The library is built at first use
(:mod:`repro_torch.kernels._build`).  Each wrapper's ``launches``
attribute counts its launches and nothing else;
``runahead_gather.route_launches`` counts the runahead gather's launches
by route (:func:`route`).  The contract on indices is ``0 <= idx < V``,
as in the JAX package; it is not checked, since that would cost a
synchronisation with the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

MAX_RUNAHEAD_DEPTH = 16          # runahead_gather is instantiated for 1..16
MAX_BAG_DEPTH = 8                # gather_bag for 1..8
MAX_SMEM_BYTES = 232_448         # dynamic shared memory a Hopper block may use
MAX_BAG_ROW_BYTES = 2048         # the bag's accumulator: 4 x 32 lanes x 16 B
BARRIER_BYTES = 8                # the bulk route's mbarrier, one a ring stage
ROUTES = ("cp_async", "bulk")    # runahead_gather_launch's route 0, 1
SM_SMEM_BYTES = 233_472          # shared memory an SM holds: 228 KB
BLOCK_RESERVED_BYTES = 1024      # of which the runtime keeps 1 KB a block
MAX_BLOCKS_PER_SM = 32
# the fewest bytes a TMA operation of the bulk route must move, over the
# blocks an SM holds, for it to beat the cp_async route
# (scripts/torch_gather_variants.py, H100)
BULK_MIN_BYTES_PER_OP = 1536
_BAG_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# each C entry point's parameters, in the order csrc/gather_runahead.cu
# declares them
ARGTYPES = {
    # (route, table, idx, out, n_tiles, block_rows, row_bytes, depth,
    #  grid_blocks, stream)
    "runahead_gather_launch": [_I32] + [_PTR] * 3 + [_I32] * 5 + [_PTR],
    # (table, idx, out, n, row_bytes, stream)
    "pipelined_gather_launch": [_PTR] * 3 + [_I32] * 2 + [_PTR],
    # (dtype, table, idx, w, out, S, K, D, depth, stream)
    "gather_bag_launch": [_I32] + [_PTR] * 4 + [_I32] * 4 + [_PTR],
    # (dtype, K, D, depth, warps)
    "gather_bag_warps_per_sm": [_I32] * 4 + [_PTR],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gather_runahead")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def bulk_fits(row_bytes: int, block_rows: int, depth: int) -> bool:
    """Whether a ring of ``depth`` tiles of ``block_rows`` rows of
    ``row_bytes`` and one barrier a stage fit a block's shared memory."""
    return depth * (block_rows * row_bytes + BARRIER_BYTES) <= MAX_SMEM_BYTES


def route(row_bytes: int, block_rows: int, depth: int) -> str:
    """The runahead gather's route for that ring, by shape alone:
    ``"bulk"`` (one TMA bulk copy a row, one bulk store a tile, one warp a
    block) where it fits (:func:`bulk_fits`) and its operations move at
    least :data:`BULK_MIN_BYTES_PER_OP` bytes each over the blocks an SM
    holds, else ``"cp_async"`` (16-byte copies through registers, eight
    warps a block).  Below that the one warp of each bulk block waits on
    its operations: 512-byte rows, 8 a tile, 15 deep fit three blocks an
    SM and run slower than on cp_async."""
    if not bulk_fits(row_bytes, block_rows, depth):
        return "cp_async"
    smem = depth * (block_rows * row_bytes + BARRIER_BYTES)
    blocks = min(MAX_BLOCKS_PER_SM,
                 SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES))
    per_op = blocks * block_rows * row_bytes / (block_rows + 1)
    return "bulk" if per_op >= BULK_MIN_BYTES_PER_OP else "cp_async"


def _check_device(who: str, **tensors) -> torch.device:
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}; every operand "
                             f"must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    return device


def _check_rows(who: str, table: torch.Tensor) -> int:
    """Row bytes of a 2-D table whose rows the kernels copy in 16-byte
    chunks."""
    if table.dim() != 2:
        raise ValueError(f"{who}: table must be [V, D], got "
                         f"{tuple(table.shape)}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or row_bytes == 0:
        raise ValueError(f"{who}: a row of D={table.shape[1]} {table.dtype} "
                         f"is {row_bytes} bytes, not a positive multiple of "
                         f"16: the kernels copy rows in 16-byte chunks")
    if table.data_ptr() % 16:
        raise ValueError(f"{who}: table must start on a 16-byte boundary")
    return row_bytes


def check_depth(who: str, depth: int, items: int, most: int) -> int:
    """The reference's clamp ``min(depth, items)``, within 1..most."""
    if not 1 <= depth <= most:
        raise ValueError(f"{who}: depth={depth} not in 1..{most}")
    return max(1, min(depth, items))


def _raise_on(who: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_index(who: str, idx: torch.Tensor, dims: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != dims:
        raise ValueError(f"{who}: idx must be a {dims}-D int32 tensor, got "
                         f"{idx.dim()}-D {idx.dtype}")
    if idx.numel() >= 2**31:
        raise ValueError(f"{who}: {idx.numel()} indices; at most 2**31 - 1")


def runahead_gather(table: torch.Tensor, idx: torch.Tensor, *,
                    block_rows: int = 8, depth: int = 2,
                    grid_blocks: int | None = None,
                    use: str | None = None) -> torch.Tensor:
    """out[i] = table[idx[i]] with ``depth`` index blocks of ``block_rows``
    row copies in flight per CUDA block.  table [V, D] (rows a multiple of
    16 bytes), idx [n] int32 with n % block_rows == 0 -> [n, D].

    ``grid_blocks`` caps the number of CUDA blocks (None: as many as fill
    the card), which fixes the rows in flight on the card at
    ``grid_blocks * depth * block_rows``: the MSHR count of the paper's
    Fig. 14 sweep.  The kernel's route is :func:`route`'s, or ``use``
    (``"bulk"`` or ``"cp_async"``: to time one against the other)."""
    who = "runahead_gather"
    _build.refuse_dtensor(who, table, idx)
    if grid_blocks is not None and grid_blocks < 1:
        raise ValueError(f"{who}: grid_blocks={grid_blocks} must be >= 1")
    if use not in (None, *ROUTES):
        raise ValueError(f"{who}: use={use!r} not in {ROUTES}")
    device = _check_device(who, table=table, idx=idx)
    row_bytes = _check_rows(who, table)
    _check_index(who, idx, 1)
    n = idx.shape[0]
    if block_rows < 1 or n % block_rows:
        raise ValueError(f"{who}: n={n} is not a multiple of "
                         f"block_rows={block_rows}")
    n_tiles = n // block_rows
    depth = check_depth(who, depth, n_tiles, MAX_RUNAHEAD_DEPTH)
    if depth * block_rows * row_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"{who}: a ring of {depth} x {block_rows} rows of "
                         f"{row_bytes} bytes exceeds {MAX_SMEM_BYTES} bytes "
                         f"of shared memory")
    if use == "bulk" and not bulk_fits(row_bytes, block_rows, depth):
        raise ValueError(f"{who}: a ring of {depth} x {block_rows} rows of "
                         f"{row_bytes} bytes leaves no room in shared memory "
                         f"for the bulk route's barriers")
    which = use or route(row_bytes, block_rows, depth)
    out = torch.empty((n, table.shape[1]), dtype=table.dtype, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().runahead_gather_launch(
            ROUTES.index(which), table.data_ptr(), idx.data_ptr(),
            out.data_ptr(), n_tiles, block_rows, row_bytes, depth,
            grid_blocks or 0, _stream(device))
    _raise_on(who, err)
    runahead_gather.launches += 1
    runahead_gather.route_launches[which] += 1
    return out


def pipelined_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]], one row per warp with no ring: the baseline
    the runahead gather is measured against."""
    who = "pipelined_gather"
    _build.refuse_dtensor(who, table, idx)
    device = _check_device(who, table=table, idx=idx)
    row_bytes = _check_rows(who, table)
    _check_index(who, idx, 1)
    n = idx.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=table.dtype, device=device)
    if n == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().pipelined_gather_launch(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes,
            _stream(device))
    _raise_on(who, err)
    pipelined_gather.launches += 1
    return out


def gather_bag(table: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
               *, depth: int = 2) -> torch.Tensor:
    """out[s] = sum_k w[s,k] * table[idx[s,k]] in float32 (rounded products
    added in k order from 0, bit for bit ``ref.gather_bag_ordered_ref``),
    cast to the table's type.  Each batch of 32 entries fetches each of its
    distinct rows once, into a warp's ring of min(K, 32) row slots.
    ``depth`` is an upper limit: a warp has up to min(depth * ceil(K / 32),
    8) batches in flight, and only while their distinct rows fit its ring,
    so a row with many distinct indices holds back the next.  table [V, D]
    float32 or bfloat16 (rows of at most 2048 bytes); idx [S, K] int32;
    weights [S, K] float32 -> [S, D]."""
    who = "gather_bag"
    _build.refuse_dtensor(who, table, idx, weights)
    device = _check_device(who, table=table, idx=idx, weights=weights)
    row_bytes = _check_rows(who, table)
    _check_index(who, idx, 2)
    if table.dtype not in _BAG_DTYPES or weights.dtype != torch.float32:
        raise ValueError(f"{who}: want a table in {list(_BAG_DTYPES)} and "
                         f"float32 weights, got {table.dtype} and "
                         f"{weights.dtype}")
    if weights.shape != idx.shape:
        raise ValueError(f"{who}: weights {tuple(weights.shape)} != idx "
                         f"{tuple(idx.shape)}")
    if row_bytes > MAX_BAG_ROW_BYTES:
        raise ValueError(f"{who}: a row of {row_bytes} bytes exceeds the "
                         f"kernel's {MAX_BAG_ROW_BYTES}-byte accumulator")
    s, k = idx.shape
    depth = check_depth(who, depth, s, MAX_BAG_DEPTH)
    # a warp's ring holds one batch, at most 32 rows of at most 2048 bytes
    # (64 KB), so every shape the checks above pass fits a block
    out = torch.empty((s, table.shape[1]), dtype=table.dtype, device=device)
    if s == 0:
        return out
    with torch.cuda.device(device):
        err = _lib().gather_bag_launch(
            _BAG_DTYPES[table.dtype], table.data_ptr(), idx.data_ptr(),
            weights.data_ptr(), out.data_ptr(), s, k, table.shape[1], depth,
            _stream(device))
    _raise_on(who, err)
    gather_bag.launches += 1
    return out


def bag_warps_per_sm(table: torch.Tensor, k: int, depth: int = 2) -> int:
    """Warps of the bag kernel an SM holds for this table, fan-in K and
    depth (the CUDA occupancy calculator; launches nothing)."""
    who = "bag_warps_per_sm"
    _check_rows(who, table)
    warps = ctypes.c_int(0)
    with torch.cuda.device(table.device):
        err = _lib().gather_bag_warps_per_sm(
            _BAG_DTYPES[table.dtype], k, table.shape[1], depth,
            ctypes.addressof(warps))
    _raise_on(who, err)
    return warps.value


runahead_gather.launches = 0
runahead_gather.route_launches = dict.fromkeys(ROUTES, 0)
pipelined_gather.launches = 0
gather_bag.launches = 0
