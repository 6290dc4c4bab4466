"""The §3.4 profiler over a grid of cache geometries, on the card.

The twin of the JAX package's ``core/cgra/jaxcache.py``: the LRU
set-associative hit series of one address stream under every (ways, line)
configuration of a :class:`ConfigGrid` at once, the ``h_i(L_i, S_i)``
grid that Algorithm 1 reads.  The reference writes it as a ``lax.scan``
over the stream under ``vmap`` over the grid; here a CUDA tensor runs
hand-written kernels (``csrc/cache_grid.cu``), and a CPU tensor runs the
plain version, a PyTorch loop over the stream vectorised over the grid.

Semantics follow ``jaxcache._single_config_scan`` step by step, including
its corners: addresses are cast to int32 (wrapping, as ``np.int32`` does),
line address, set and tag use floor division and floor modulo, tags start
at -1 (so a wrapped address whose tag is -1 hits in a cold set, as in the
reference), a hit takes the first matching way, a miss evicts the way with
the oldest stamp among the first ``n_ways`` (ties to the lowest way), and
``ways == 0`` never hits.  The reference's padding of the stream to 4,096
buckets (a compile-cache device) is dropped: it never changes a hit.

The kernels compute the same function another way, by LRU inclusion.
Configurations with one (line, sets) pair form a group.  Within a group an
access hits under ``w`` ways exactly when its stack distance in its set
(the number of distinct tags of that set used since its own last use) is
below ``w``, so one LRU stack per (group, set), capped at the group's
largest ``ways``, answers for every configuration of the group.  The cold
ways are one tag -1 at depth 0: the reference's copies of -1 with stamp 0
are evicted first, lowest way first, which is LRU order with -1 used at
time 0.  An access with the same tag as the previous access to its set
has depth 0 and changes nothing.  :func:`hit_series_stack_ref` is that
computation in plain Python, in the kernels' order.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build

MAX_WAYS = 32                    # one lane of a warp per stack depth
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# cache_grid_launch(addrs, T, groups, G, n_chains, configs, C, pairs, depth,
# hits, stream)
LAUNCH_ARGTYPES = [_ptr, _i32, _ptr, _i32, _i32, _ptr, _i32, _ptr, _ptr,
                   _ptr, _ptr]


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


@dataclasses.dataclass(frozen=True)
class Groups:
    """The configurations of a grid grouped by their (line, sets) pair, in
    order of first appearance: ``lines``, ``sets`` and ``caps`` (the
    group's largest ``ways``) are [G]; ``of_config`` [C] is each
    configuration's group."""

    lines: np.ndarray
    sets: np.ndarray
    caps: np.ndarray
    of_config: np.ndarray

    def __len__(self) -> int:
        return len(self.lines)

    @property
    def chains(self) -> int:
        """(group, set) stacks that the kernels walk: every set of each
        group with a cache (a group whose ``cap`` is 0 never hits)."""
        return int(self.sets[self.caps > 0].astype(np.int64).sum())


def config_groups(grid: ConfigGrid) -> Groups:
    """Group the grid's configurations by (line, sets), from its numpy
    arrays (no device work)."""
    index: dict[tuple, int] = {}
    of_config = np.array([index.setdefault(pair, len(index)) for pair in
                          zip(grid.lines.tolist(), grid.sets.tolist())],
                         dtype=np.int64)
    pairs = np.array(list(index), dtype=np.int64).reshape(-1, 2)
    caps = np.zeros(len(index), np.int64)
    np.maximum.at(caps, of_config, grid.ways.astype(np.int64))
    return Groups(lines=pairs[:, 0], sets=pairs[:, 1], caps=caps,
                  of_config=of_config)


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


def _sets_and_tags(addrs: np.ndarray, line: int, sets: int) -> tuple:
    """Set and tag of each int32 address (as int64): floor division and
    floor modulo, as jnp's // and % give them."""
    line_addr = addrs.astype(np.int64) // line
    return line_addr % sets, line_addr // sets


def hit_series_stack_ref(addrs: torch.Tensor,
                         grid: ConfigGrid) -> torch.Tensor:
    """The kernels' function in plain Python and numpy: [C, T] hits of
    int32 ``addrs`` [T], equal to :func:`hit_series_ref`.

    In the kernels' order: each access's depth in its (group, set) LRU
    stack, capped at the group's ``cap`` (a miss under every ``ways`` of
    the group is ``cap``); each set's stack starts as tag -1 at depth 0;
    an access with the previous tag of its set is depth 0 and changes
    nothing, any other finds its depth and moves to the front.  A
    configuration hits where ``depth < ways``."""
    groups = config_groups(grid)
    a = addrs.cpu().numpy()
    depth = np.zeros((len(groups), a.shape[0]), np.uint8)
    for g in range(len(groups)):
        cap = int(groups.caps[g])
        if cap == 0:
            continue
        sets, tags = _sets_and_tags(a, groups.lines[g], groups.sets[g])
        stacks: dict[int, list] = {}
        row = depth[g]
        for t, (s, tag) in enumerate(zip(sets.tolist(), tags.tolist())):
            stack = stacks.setdefault(s, [-1])
            if stack[0] == tag:
                continue                       # a repeat: depth 0
            try:
                p = stack.index(tag)
                del stack[p]
            except ValueError:
                p = cap
                if len(stack) == cap:
                    stack.pop()
            stack.insert(0, tag)
            row[t] = p
    hits = depth[groups.of_config] < grid.ways.astype(np.int64)[:, None]
    return torch.from_numpy(hits).to(addrs.device)


def longest_chain(addrs, grid: ConfigGrid) -> int:
    """The most accesses of one (group, set) stack that are not repeats of
    the previous tag of their set: the longest dependent chain the kernels
    walk for this stream (a group with ``cap`` 0 has none)."""
    a = as_int32(addrs, "cpu").numpy()
    groups = config_groups(grid)
    longest = 0
    for g in range(len(groups)):
        if groups.caps[g] == 0 or a.shape[0] == 0:
            continue
        sets, tags = _sets_and_tags(a, groups.lines[g], groups.sets[g])
        order = np.argsort(sets, kind="stable")
        s, tg = sets[order], tags[order]
        prev = np.concatenate(([-1], tg[:-1]))
        prev[np.concatenate(([True], s[1:] != s[:-1]))] = -1   # cold: -1
        steps = np.bincount(s[tg != prev])
        longest = max(longest, int(steps.max(initial=0)))
    return longest


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("cache_grid")
    lib.cache_grid_launch.argtypes = LAUNCH_ARGTYPES
    lib.cache_grid_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=32)
def _device_tables(key: tuple, device: torch.device) -> tuple:
    """The kernels' group table [G, 4] int32 (line, sets, cap, end: one
    past the group's last chain) and configuration table [C, 2] int32
    (group, ways), uploaded once per grid and device, so that a call
    copies nothing from the host (a CUDA graph can capture it)."""
    grid = ConfigGrid(*(np.frombuffer(b, np.int32) for b in key[:3]),
                      max_sets=key[3], max_ways=key[4])
    groups = config_groups(grid)
    end = np.cumsum(np.where(groups.caps > 0, groups.sets, 0))
    group_table = np.stack([groups.lines, groups.sets, groups.caps, end],
                           axis=1).astype(np.int32)
    config_table = np.stack([groups.of_config, grid.ways],
                            axis=1).astype(np.int32)
    return (torch.from_numpy(group_table).to(device),
            torch.from_numpy(config_table).to(device), len(groups),
            int(end[-1]))


def cache_grid_scan(addrs: torch.Tensor, grid: ConfigGrid) -> torch.Tensor:
    """Launch the kernels: int32 ``addrs`` [T] on a CUDA device -> [C, T]
    bool hits.  CUDA tensors only; raises on anything else.  One call is
    three CUDA kernels on the current stream: the split pass (set and tag
    of every access under every (line, sets) group, [G, T] int32 pairs of
    scratch), the stack pass (one warp per (group, set) chain, writing each
    access's capped stack depth, [G, T] bytes of scratch) and the expand
    pass (``depth < ways`` per configuration); a grid whose every ``ways``
    is 0 runs the expand pass alone.  Its ``launches`` attribute counts
    calls that launched and nothing else."""
    _build.refuse_dtensor("cache_grid_scan", addrs)
    if addrs.device.type != "cuda":
        raise ValueError(f"cache_grid_scan: addrs is on {addrs.device}; the "
                         f"kernel takes a CUDA tensor")
    if addrs.dtype != torch.int32 or addrs.dim() != 1 \
            or not addrs.is_contiguous():
        raise ValueError("cache_grid_scan: addrs must be a contiguous 1-D "
                         "int32 tensor")
    if not 1 <= grid.max_ways <= MAX_WAYS:
        raise ValueError(f"cache_grid_scan: max_ways={grid.max_ways} not in "
                         f"1..{MAX_WAYS} (one lane per stack depth)")
    if (grid.ways < 0).any() or (grid.ways > grid.max_ways).any() \
            or (grid.lines < 1).any() or (grid.sets < 1).any() \
            or (grid.sets > grid.max_sets).any():
        raise ValueError("cache_grid_scan: want lines, sets >= 1, sets <= "
                         "max_sets and 0 <= ways <= max_ways")
    t_len = addrs.shape[0]
    if t_len > 2**31 - 1:
        raise ValueError(f"cache_grid_scan: {t_len} accesses; at most "
                         f"2**31 - 1")
    device = addrs.device
    hits = torch.empty((len(grid), t_len), dtype=torch.bool, device=device)
    if t_len == 0 or len(grid) == 0:
        return hits
    key = (np.ascontiguousarray(grid.lines, np.int32).tobytes(),
           np.ascontiguousarray(grid.sets, np.int32).tobytes(),
           np.ascontiguousarray(grid.ways, np.int32).tobytes(),
           int(grid.max_sets), int(grid.max_ways))
    groups, configs, n_groups, n_chains = _device_tables(key, device)
    if n_groups > 65535:
        raise ValueError(f"cache_grid_scan: {n_groups} (line, sets) groups; "
                         f"at most 65,535 (a grid dimension)")
    pairs = torch.empty((n_groups, t_len, 2), dtype=torch.int32,
                        device=device)
    depth = torch.empty((n_groups, t_len), dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        err = _lib().cache_grid_launch(
            addrs.data_ptr(), t_len, groups.data_ptr(), n_groups, n_chains,
            configs.data_ptr(), len(grid), pairs.data_ptr(), depth.data_ptr(),
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
    """[C] total misses per configuration (int64), on ``device`` (CUDA
    when None).  A CPU tensor takes :func:`hit_series_stack_ref`, the same
    function as :func:`hit_series`' plain loop, which skips the repeats
    of a set's last tag and steps no configuration it does not touch."""
    a = as_int32(addrs, resolve_device(device))
    if a.device.type == "cpu":
        hits = hit_series_stack_ref(a, grid)
    elif a.device.type == "cuda":
        hits = cache_grid_scan(a, grid)
    else:
        raise ValueError(f"miss_counts: no kernel for device {a.device}")
    return (~hits).sum(dim=1)
