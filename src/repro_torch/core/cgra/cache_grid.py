"""The §3.4 profiler over a grid of cache geometries, on the card.

The twin of the JAX package's ``core/cgra/jaxcache.py``: the LRU
set-associative hit series of one address stream under every (ways, line)
configuration of a :class:`ConfigGrid` at once, the ``h_i(L_i, S_i)``
grid that Algorithm 1 reads.  The reference writes it as a ``lax.scan``
over the stream under ``vmap`` over the grid; here a CUDA tensor runs one
hand-written kernel (``csrc/cache_grid.cu``), and a CPU tensor runs the
plain version, a PyTorch loop over the stream vectorised over the grid.

Semantics follow ``jaxcache._single_config_scan`` step by step, including
its corners: addresses are cast to int32 (wrapping, as ``np.int32`` does),
line address, set and tag use floor division and floor modulo, tags start
at -1 (so a wrapped address whose tag is -1 hits in a cold set, as in the
reference), a hit takes the first matching way, a miss evicts the way with
the oldest stamp among the first ``n_ways`` (ties to the lowest way), and
``ways == 0`` never hits.  The reference's padding of the stream to 4,096
buckets (a compile-cache device) is dropped: it never changes a hit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build

MAX_WAYS = 32                    # one lane of a warp per way
MAX_SMEM_BYTES = 232_448         # dynamic shared memory a Hopper block may use


@dataclasses.dataclass(frozen=True)
class ConfigGrid:
    """A batch of cache geometries, padded to common maxima (a copy of
    ``jaxcache.ConfigGrid``)."""

    lines: np.ndarray      # [C] int32 line size (bytes)
    sets: np.ndarray       # [C] int32 number of sets (way_bytes // line)
    ways: np.ndarray       # [C] int32 associativity (0 = cache disabled)
    max_sets: int
    max_ways: int

    @staticmethod
    def build(way_bytes: int, ways_options, line_options) -> "ConfigGrid":
        lines, sets, ways = [], [], []
        for w in ways_options:
            for ln in line_options:
                lines.append(ln)
                sets.append(max(1, way_bytes // ln))
                ways.append(w)
        return ConfigGrid(
            lines=np.asarray(lines, np.int32),
            sets=np.asarray(sets, np.int32),
            ways=np.asarray(ways, np.int32),
            max_sets=int(max(sets)),
            max_ways=int(max(max(ways), 1)),
        )

    def __len__(self) -> int:
        return len(self.lines)


def as_int32(addrs, device) -> torch.Tensor:
    """Addresses as an int32 tensor on ``device``, wrapped modulo 2**32 as
    the reference's ``astype(np.int32)`` wraps them."""
    if isinstance(addrs, torch.Tensor):
        a = addrs.to(device=device, dtype=torch.int64)
    else:
        a = torch.as_tensor(np.asarray(addrs, dtype=np.int64), device=device)
    a = a & 0xFFFFFFFF
    return torch.where(a >= 2**31, a - 2**32, a).to(torch.int32)


def _grid_tensors(grid: ConfigGrid, device, dtype) -> tuple:
    return tuple(torch.as_tensor(np.asarray(x), device=device, dtype=dtype)
                 for x in (grid.lines, grid.sets, grid.ways))


def hit_series_ref(addrs: torch.Tensor, grid: ConfigGrid) -> torch.Tensor:
    """The plain version: [C, T] hit booleans of int32 ``addrs`` [T] under
    every configuration, one PyTorch step per access for all C at once.

    Per step: the tags and stamps of each configuration's set, then one
    ``min`` over a key that is -1 on a matching way and the way's stamp
    elsewhere, so it picks the first matching way or else the oldest stamp,
    ties to the lowest way (jnp's argmax / argmin pick the first index, as
    torch's do).  Ways past a configuration's ``n_ways`` hold a tag no
    int32 address can produce and the largest stamp, so they never match
    and are never evicted.  A configuration with ``ways == 0`` is left out
    of the loop: it never hits and its state never changes."""
    device = addrs.device
    lines, sets, ways = _grid_tensors(grid, device, torch.int64)
    t_len, w = addrs.shape[0], grid.max_ways
    hits = torch.zeros((len(grid), t_len), dtype=torch.bool, device=device)
    live = torch.nonzero(ways > 0).flatten()
    if t_len == 0 or live.numel() == 0:
        return hits
    lines, sets, ways = lines[live], sets[live], ways[live]
    c = live.numel()
    line_addr = torch.div(addrs.long()[:, None], lines[None, :],
                          rounding_mode="floor")                  # [T, c]
    # flat row of (configuration, set) in the [c * max_sets, W] state
    row_of = (torch.arange(c, device=device)[None, :] * grid.max_sets
              + torch.remainder(line_addr, sets[None, :])).contiguous()
    tag_of = torch.div(line_addr, sets[None, :], rounding_mode="floor") \
        .contiguous()
    way_mask = (torch.arange(w, device=device)[None, :] < ways[:, None]) \
        .repeat_interleave(grid.max_sets, dim=0)       # [c * max_sets, W]
    tags = torch.where(way_mask, -1, 2**40)
    stamps = torch.where(way_mask, 0, torch.iinfo(torch.int64).max)
    key_min = torch.empty((t_len, c), dtype=torch.int64, device=device)
    for t in range(t_len):
        row, tag = row_of[t], tag_of[t]
        match = tags[row] == tag[:, None]                         # [c, W]
        key_min[t], way = torch.where(match, -1, stamps[row]).min(dim=1)
        tags[row, way] = tag
        stamps[row, way] = t + 1
    hits[live] = (key_min < 0).T
    return hits


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cache_grid")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cache_grid_launch.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32,
                                      ptr, ptr]
    lib.cache_grid_launch.restype = ctypes.c_int
    return lib


def cache_grid_scan(addrs: torch.Tensor, grid: ConfigGrid) -> torch.Tensor:
    """Launch the kernel: int32 ``addrs`` [T] on a CUDA device -> [C, T]
    bool hits.  CUDA tensors only; raises on anything else.  Its
    ``launches`` attribute counts launches and nothing else."""
    if addrs.device.type != "cuda":
        raise ValueError(f"cache_grid_scan: addrs is on {addrs.device}; the "
                         f"kernel takes a CUDA tensor")
    if addrs.dtype != torch.int32 or addrs.dim() != 1 \
            or not addrs.is_contiguous():
        raise ValueError("cache_grid_scan: addrs must be a contiguous 1-D "
                         "int32 tensor")
    if not 1 <= grid.max_ways <= MAX_WAYS:
        raise ValueError(f"cache_grid_scan: max_ways={grid.max_ways} not in "
                         f"1..{MAX_WAYS} (one lane per way)")
    if (grid.ways < 0).any() or (grid.ways > grid.max_ways).any() \
            or (grid.lines < 1).any() or (grid.sets < 1).any() \
            or (grid.sets > grid.max_sets).any():
        raise ValueError("cache_grid_scan: want lines, sets >= 1, sets <= "
                         "max_sets and 0 <= ways <= max_ways")
    if 8 * grid.max_sets * grid.max_ways > MAX_SMEM_BYTES:
        raise ValueError(f"cache_grid_scan: {grid.max_sets} sets x "
                         f"{grid.max_ways} ways of tags and stamps exceed "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    t_len = addrs.shape[0]
    if t_len >= 2**31 - 1:
        raise ValueError(f"cache_grid_scan: {t_len} accesses; the step "
                         f"stamps are int32")
    device = addrs.device
    lines, sets, ways = _grid_tensors(grid, device, torch.int32)
    hits = torch.empty((len(grid), t_len), dtype=torch.bool, device=device)
    if t_len == 0 or len(grid) == 0:
        return hits
    with torch.cuda.device(device):
        err = _lib().cache_grid_launch(
            addrs.data_ptr(), t_len, lines.data_ptr(), sets.data_ptr(),
            ways.data_ptr(), len(grid), grid.max_sets, grid.max_ways,
            hits.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cache_grid_scan: kernel launch failed with CUDA "
                           f"error {err}")
    cache_grid_scan.launches += 1
    return hits


cache_grid_scan.launches = 0


def hit_series(addrs, grid: ConfigGrid, device=None) -> torch.Tensor:
    """[C, T] hit booleans for every configuration in the grid, on
    ``device`` (CUDA when None; raises if there is none).  ``addrs`` is
    array-like or a tensor of integer addresses."""
    a = as_int32(addrs, resolve_device(device))
    if a.device.type == "cpu":
        return hit_series_ref(a, grid)
    if a.device.type == "cuda":
        return cache_grid_scan(a, grid)
    raise ValueError(f"hit_series: no kernel for device {a.device}")


def miss_counts(addrs, grid: ConfigGrid, device=None) -> torch.Tensor:
    """[C] total misses per configuration (int64)."""
    return (~hit_series(addrs, grid, device)).sum(dim=1)
