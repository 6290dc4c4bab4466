"""A copy of ``repro.core.cgra.trace`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).  The tests the text below
names are the reference's.

Kernel -> memory-access trace generators for the CGRA simulator.

The paper (Table 1) evaluates eight kernels whose defining property is the mix
of *regular* (sequential / strided) and *irregular* (indirect ``a[b[i]]``)
memory accesses.  We reproduce each kernel as a trace generator: a program-order
list of memory accesses annotated with the dependence information the paper's
dummy-bit hardware tracks (``addr_dep`` = index of the earlier *load* whose
value forms this access's address; ``-1`` for regular accesses).

A trace entry is (pe, addr, is_store, addr_dep, iter_id):
  * ``pe``       memory-access PE issuing the request (border PEs, §2.1)
  * ``addr``     byte address in a flat kernel address space
  * ``is_store`` load vs store
  * ``addr_dep`` trace index of the address-producing load (irregular access)
  * ``iter_id``  loop iteration; the CGRA issues iteration *i*'s requests in
                 the same II window (deterministic static schedule, §2.2)

Datasets for the GCN ``aggregate`` kernel are synthetic graphs matched to the
node/edge counts of Citeseer / Cora / PubMed / OGBN-Arxiv (the latter scaled
1/10 to keep simulation time bounded, as the paper itself reduces feature
dimensions "to control simulation time").
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

ELEM = 4          # bytes per element (HyCUBE is a 32-bit datapath, §4.5)
_ALIGN = 256      # array base alignment (max virtual-line size)


@dataclasses.dataclass(frozen=True)
class Array:
    """A named data region in the kernel's flat address space."""

    name: str
    base: int
    size: int  # bytes

    @property
    def end(self) -> int:
        return self.base + self.size

    def addr(self, index):
        """Byte address(es) of ``self[index]`` (element granularity)."""
        return self.base + np.asarray(index, dtype=np.int64) * ELEM


@dataclasses.dataclass
class Trace:
    """Program-order memory-access trace of a mapped kernel.

    Derived views that the simulator hot loop needs on every run (iteration
    boundaries, plain-list columns, SPM membership masks) are computed once
    and memoized on the trace, so sweeping many :class:`SimConfig` points over
    one trace pays the preprocessing cost a single time.
    """

    name: str
    pe: np.ndarray        # int16  [N]
    addr: np.ndarray      # int64  [N]
    is_store: np.ndarray  # bool   [N]
    addr_dep: np.ndarray  # int32  [N] (-1 = regular)
    iter_id: np.ndarray   # int32  [N]
    arrays: dict[str, Array]
    ii: int               # initiation interval of the mapped DFG
    n_iters: int
    _memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    def __len__(self) -> int:
        return int(self.addr.shape[0])

    @property
    def irregular_fraction(self) -> float:
        """Fraction of accesses whose address depends on a loaded value."""
        return float(np.mean(self.addr_dep >= 0))

    def footprint(self) -> int:
        return sum(a.size for a in self.arrays.values())

    # -- memoized derived views (simulator hot-loop preprocessing) ----------
    def iter_starts(self) -> np.ndarray:
        """Iteration boundary indices (with a trailing ``len(self)``)."""
        if "iter_starts" not in self._memo:
            starts = np.flatnonzero(np.r_[True, np.diff(self.iter_id) != 0])
            self._memo["iter_starts"] = np.r_[starts, len(self)]
        return self._memo["iter_starts"]

    def as_lists(self) -> tuple[list, list, list, list, list]:
        """The five trace columns as plain Python lists.

        Indexing a Python list in the cycle-by-cycle walk is several times
        faster than pulling NumPy scalars out of an ndarray, and the
        conversion is paid once per trace rather than once per access per
        swept configuration.
        """
        if "lists" not in self._memo:
            self._memo["lists"] = (self.pe.tolist(), self.addr.tolist(),
                                   self.is_store.tolist(),
                                   self.addr_dep.tolist(),
                                   self.iter_id.tolist())
        return self._memo["lists"]

    def spm_mask(self, spm_bytes: int) -> np.ndarray:
        """Memoized :func:`plan_spm` (the plan is pure in (trace, size))."""
        key = ("spm", int(spm_bytes))
        if key not in self._memo:
            self._memo[key] = plan_spm(self, spm_bytes)
        return self._memo[key]

    def cache_index(self, n_caches: int) -> np.ndarray:
        """Per-access L1 id under the round-robin PE->cache map (§3.3)."""
        key = ("cache_of", int(n_caches))
        if key not in self._memo:
            self._memo[key] = (self.pe.astype(np.int64) % n_caches)
        return self._memo[key]

    def iter_index(self) -> np.ndarray:
        """Per-access iteration *ordinal* (0..n_iters-1, index into
        ``iter_starts``), unlike ``iter_id`` which is whatever the builder
        recorded.  Lets the engines map any access to its II window."""
        if "iter_index" not in self._memo:
            starts = self.iter_starts()
            sizes = np.diff(starts)
            self._memo["iter_index"] = np.repeat(
                np.arange(len(sizes), dtype=np.int64), sizes)
        return self._memo["iter_index"]

    def arbitration_extra(self, spm_bytes: int, n_caches: int) -> np.ndarray:
        """Per-iteration same-cycle L1 arbitration penalty (§3.1), memoized.

        The k-th same-cycle request to one L1 waits k cycles beyond the II's
        scheduled issue slots, so an iteration pays ``max_c(count_c) - ii``
        extra cycles when any single L1 receives more than ``ii`` non-SPM
        requests.  Both the scalar and the batched engine consume this view,
        so a sweep of many timing-only variants pays the bincount once.
        """
        key = ("extra", int(spm_bytes), int(n_caches))
        if key not in self._memo:
            starts = self.iter_starts()
            n_iters = len(starts) - 1
            if n_iters == 0 or not len(self):
                extra = np.zeros(n_iters, dtype=np.int64)
            else:
                sel = ~self.spm_mask(spm_bytes)
                key_arr = (self.iter_index()[sel] * n_caches
                           + self.cache_index(n_caches)[sel])
                cnt = np.bincount(key_arr, minlength=n_iters * n_caches)
                per_iter_max = cnt.reshape(n_iters, n_caches).max(axis=1)
                extra = np.maximum(0, per_iter_max - self.ii)
            self._memo[key] = extra
        return self._memo[key]

    def active_index(self, spm_bytes: int) -> np.ndarray:
        """Indices of non-SPM accesses (the demand engines' work list).

        Both the batched engine's content phase and the runahead engine's
        demand walk iterate only these accesses; memoizing the
        ``flatnonzero`` keeps a sweep of many same-SPM configs from
        re-deriving it per lane group."""
        key = ("act", int(spm_bytes))
        if key not in self._memo:
            self._memo[key] = np.flatnonzero(~self.spm_mask(spm_bytes))
        return self._memo[key]

    def walker_index(self, spm_bytes: int) -> np.ndarray:
        """Indices the §3.2 runahead walker must visit under ``spm_bytes``.

        The walker can skip an access only when it is an SPM **load with no
        address dependence**: SPM stores redirect to temporary storage,
        dep-carrying accesses propagate dummy bits, and every non-SPM access
        probes the L1.  Everything else is walker-relevant."""
        key = ("walk", int(spm_bytes))
        if key not in self._memo:
            mask = self.spm_mask(spm_bytes)
            self._memo[key] = np.flatnonzero(
                ~mask | self.is_store | (self.addr_dep >= 0))
        return self._memo[key]

    def active_lists(self, spm_bytes: int) -> dict:
        """Memoized plain-list views of the demand work list: trace indices
        and store flags of non-SPM accesses, plus ``(iteration, lo, hi)``
        rows for the iterations that have any demand work (the runahead
        engine's bulk-advance structure).  Geometry-independent, so every
        lane group of one ``spm_bytes`` shares a single conversion."""
        key = ("act_lists", int(spm_bytes))
        if key not in self._memo:
            act = self.active_index(spm_bytes)
            bounds = np.searchsorted(act, self.iter_starts())
            lo, hi = bounds[:-1], bounds[1:]
            ne = np.flatnonzero(hi > lo)
            self._memo[key] = {
                "a_j": act.tolist(),
                "a_store": self.is_store[act].tolist(),
                "it_rows": list(zip(ne.tolist(), lo[ne].tolist(),
                                    hi[ne].tolist())),
            }
        return self._memo[key]

    def walker_lists(self, spm_bytes: int) -> dict:
        """Memoized plain-list views over :meth:`walker_index` (trace
        indices, deps, store/SPM flags, addresses, iteration ordinals, and
        per-iteration bounds).  Geometry-independent for the same reason as
        :meth:`active_lists`."""
        key = ("walk_lists", int(spm_bytes))
        if key not in self._memo:
            rel = self.walker_index(spm_bytes)
            self._memo[key] = {
                "rel": rel.tolist(),
                "w_dep": self.addr_dep[rel].tolist(),
                "w_store": self.is_store[rel].tolist(),
                "w_spm": self.spm_mask(spm_bytes)[rel].tolist(),
                "w_addr": self.addr[rel].tolist(),
                "w_ord": self.iter_index()[rel].tolist(),
                "rel_bounds": np.searchsorted(rel,
                                              self.iter_starts()).tolist(),
            }
        return self._memo[key]

    def geometry_lists(self, spm_bytes: int, n_caches: int,
                       geometry: tuple) -> dict:
        """Memoized per-L1-geometry columns of the runahead engine's work
        lists: flat-set index, tag, line and cache id for both the demand
        (``a_*``) and walker (``w_*``) lists.

        ``geometry`` is ``((ways, line, way_bytes), ...)`` per cache.  The
        *flat set* index concatenates every cache's sets into one axis
        (``cum_sets[c] + set``), so the engines address per-lane way arrays
        with a single precomputed subscript — no per-access cache indirection.
        Lane groups share these columns across every lane and every task of
        one (spm, n_caches, geometry); the reference's
        ``sweep.prewarm_traces`` builds them pre-fork so workers inherit
        them copy-on-write.
        """
        key = ("geom_lists", int(spm_bytes), int(n_caches), geometry)
        if key not in self._memo:
            lines_g = [g[1] for g in geometry]
            sets_g = [max(1, g[2] // g[1]) for g in geometry]
            cum = np.concatenate(([0], np.cumsum(sets_g)))[:-1]
            cache_idx = self.cache_index(n_caches)
            if len(set(zip(lines_g, sets_g))) == 1:
                line = self.addr // lines_g[0]
                nsets = sets_g[0]
            else:
                line = self.addr // np.asarray(lines_g,
                                               dtype=np.int64)[cache_idx]
                nsets = np.asarray(sets_g, dtype=np.int64)[cache_idx]
            fs_arr = cum[cache_idx] + line % nsets
            tag_arr = line // nsets
            act = self.active_index(spm_bytes)
            rel = self.walker_index(spm_bytes)
            self._memo[key] = {
                "cum_sets": cum.tolist(),
                "a_c": cache_idx[act].tolist(),
                "a_fs": fs_arr[act].tolist(),
                "a_tag": tag_arr[act].tolist(),
                "a_line": line[act].tolist(),
                "w_c": cache_idx[rel].tolist(),
                "w_fs": fs_arr[rel].tolist(),
                "w_tag": tag_arr[rel].tolist(),
                "w_line": line[rel].tolist(),
            }
        return self._memo[key]

    def last_line_use(self, n_caches: int, cache: int,
                      line_bytes: int) -> dict:
        """``line_addr -> last trace index`` for the accesses cache ``cache``
        serves (ignoring SPM residency, like the Fig. 15 classifier), under
        ``line_bytes`` lines.  Memoized so prefetch classification stops
        rebuilding the per-cache line map for every simulated config."""
        key = ("last_line", int(n_caches), int(cache), int(line_bytes))
        if key not in self._memo:
            idxs = np.flatnonzero(self.cache_index(n_caches) == cache)
            lines = self.addr[idxs] // line_bytes
            # dict() keeps the *last* assignment per key: idxs are ascending
            self._memo[key] = dict(zip(lines.tolist(), idxs.tolist()))
        return self._memo[key]


def plan_spm(trace: Trace, spm_bytes: int) -> np.ndarray:
    """Compile-time SPM allocation: pin array prefixes greedily by access
    density (accesses per byte).  Returns a per-access ``in_spm`` mask."""
    if spm_bytes <= 0:
        return np.zeros(len(trace), dtype=bool)
    arrays = list(trace.arrays.values())
    counts = {a.name: 0 for a in arrays}
    bases = np.array([a.base for a in arrays], dtype=np.int64)
    order = np.argsort(bases)
    sorted_bases = bases[order]
    which = np.searchsorted(sorted_bases, trace.addr, side="right") - 1
    cnt = np.bincount(which, minlength=len(arrays))
    for k, a_idx in enumerate(order):
        counts[arrays[a_idx].name] = int(cnt[k])

    remaining = spm_bytes
    pinned: list[tuple[int, int]] = []
    for a in sorted(arrays, key=lambda a: counts[a.name] / max(1, a.size),
                    reverse=True):
        if remaining <= 0:
            break
        take = min(a.size, remaining)
        pinned.append((a.base, a.base + take))
        remaining -= take

    mask = np.zeros(len(trace), dtype=bool)
    for lo, hi in pinned:
        mask |= (trace.addr >= lo) & (trace.addr < hi)
    return mask


class _TraceBuilder:
    def __init__(self, name: str, ii: int):
        self.name = name
        self.ii = ii
        self.pe: list[int] = []
        self.addr: list[int] = []
        self.is_store: list[int] = []
        self.addr_dep: list[int] = []
        self.iter_id: list[int] = []
        self.arrays: dict[str, Array] = {}
        self._cursor = 0
        self._iter = 0

    def array(self, name: str, n_elems: int) -> Array:
        base = (self._cursor + _ALIGN - 1) // _ALIGN * _ALIGN
        arr = Array(name, base, int(n_elems) * ELEM)
        self._cursor = arr.end
        self.arrays[name] = arr
        return arr

    def access(self, pe: int, addr: int, store: bool = False, dep: int = -1) -> int:
        """Append one access; returns its trace index (for ``dep`` chaining)."""
        idx = len(self.addr)
        self.pe.append(pe)
        self.addr.append(int(addr))
        self.is_store.append(int(store))
        self.addr_dep.append(int(dep))
        self.iter_id.append(self._iter)
        return idx

    def load(self, pe: int, addr: int, dep: int = -1) -> int:
        return self.access(pe, addr, store=False, dep=dep)

    def store(self, pe: int, addr: int, dep: int = -1) -> int:
        return self.access(pe, addr, store=True, dep=dep)

    def next_iter(self) -> None:
        self._iter += 1

    def build(self) -> Trace:
        return Trace(
            name=self.name,
            pe=np.asarray(self.pe, dtype=np.int16),
            addr=np.asarray(self.addr, dtype=np.int64),
            is_store=np.asarray(self.is_store, dtype=bool),
            addr_dep=np.asarray(self.addr_dep, dtype=np.int32),
            iter_id=np.asarray(self.iter_id, dtype=np.int32),
            arrays=self.arrays,
            ii=self.ii,
            n_iters=self._iter,
        )


# ---------------------------------------------------------------------------
# Synthetic graphs (power-law degree, CSR edge order)
# ---------------------------------------------------------------------------

#: (nodes, edges) matched to the paper's datasets [34, 16].
GCN_DATASETS: dict[str, tuple[int, int]] = {
    "citeseer": (3_327, 9_104),
    "cora": (2_708, 10_556),
    "pubmed": (19_717, 88_648),
    # OGBN-Arxiv is (169_343, 1_166_243); scaled 1/10 for simulation time.
    "ogbn_arxiv": (16_934, 116_624),
}


def _powerlaw_graph(n_nodes: int, n_edges: int, rng: np.random.Generator,
                    alpha: float = 1.5, csr: bool = False):
    """CSR-ordered edge list with Zipf-distributed destinations.

    Sources are sorted (CSR iteration order -> ``edge_start`` is monotone, the
    regular stream the paper highlights); destinations follow a power law
    (graph hubs -> some cache reuse, most accesses irregular).

    With ``csr=True`` also returns the ``[n_nodes + 1]`` row-pointer array, so
    callers that walk per-node adjacency (the frontier workloads in
    :mod:`repro_torch.core.cgra.workloads`) share this generator instead of
    re-deriving offsets from the sorted sources.
    """
    src = np.sort(rng.integers(0, n_nodes, size=n_edges))
    ranks = rng.zipf(alpha, size=n_edges) % n_nodes
    perm = rng.permutation(n_nodes)  # detach hub ids from low addresses
    dst = perm[ranks]
    src, dst = src.astype(np.int64), dst.astype(np.int64)
    if not csr:
        return src, dst
    indptr = np.concatenate(
        ([0], np.cumsum(np.bincount(src, minlength=n_nodes)))).astype(np.int64)
    return src, dst, indptr


# ---------------------------------------------------------------------------
# Kernels (Table 1)
# ---------------------------------------------------------------------------

def gcn_aggregate(dataset: str = "cora", feat_dim: int = 2, n_pes: int = 4,
                  seed: int = 0, max_edges: int | None = None) -> Trace:
    """Listing 1: ``output[edge_start[i]] += weight[i] * feature[edge_end[i]]``.

    Per edge: 3 regular loads (edge_start, edge_end, weight), ``feat_dim``
    irregular feature loads, one irregular output load + store (RMW).
    """
    n_nodes, n_edges = GCN_DATASETS[dataset]
    if max_edges is not None:
        n_edges = min(n_edges, max_edges)
    rng = np.random.default_rng(seed)
    src, dst = _powerlaw_graph(n_nodes, n_edges, rng)

    b = _TraceBuilder(f"gcn_{dataset}", ii=2)
    e_start = b.array("edge_start", n_edges)
    e_end = b.array("edge_end", n_edges)
    weight = b.array("weight", n_edges)
    feat = b.array("feature", n_nodes * feat_dim)
    out = b.array("output", n_nodes * feat_dim)

    for i in range(n_edges):
        j_start = b.load(0, e_start.addr(i))
        j_end = b.load(1, e_end.addr(i))
        b.load(2, weight.addr(i))
        for d in range(feat_dim):
            b.load(1, feat.addr(dst[i] * feat_dim + d), dep=j_end)
        # output RMW through the edge_start value (CSR order -> regular-ish
        # addresses, but still an address dependence the dummy bits track)
        b.load(3, out.addr(src[i] * feat_dim), dep=j_start)
        b.store(3, out.addr(src[i] * feat_dim), dep=j_start)
        b.next_iter()
    return b.build()


def grad(n_cells: int = 16_384, n_faces: int = 24_576, n_pes: int = 4,
         seed: int = 1) -> Trace:
    """OpenFOAM gradient: per mesh face, gather owner/neighbour cell values.

    Owner indices are sorted (mesh faces enumerated per cell); neighbour
    indices are random (unstructured mesh) -> highly irregular (§4.3 notes
    ``grad`` is among the most random kernels).
    """
    rng = np.random.default_rng(seed)
    owner = np.sort(rng.integers(0, n_cells, size=n_faces))
    neigh = rng.integers(0, n_cells, size=n_faces)

    b = _TraceBuilder("grad", ii=3)
    own = b.array("owner", n_faces)
    nei = b.array("neighbour", n_faces)
    sf = b.array("sf", n_faces)
    phi = b.array("phi", n_cells)
    g = b.array("grad", n_cells)

    for f in range(n_faces):
        j_o = b.load(0, own.addr(f))
        j_n = b.load(1, nei.addr(f))
        b.load(2, sf.addr(f))
        b.load(0, phi.addr(owner[f]), dep=j_o)
        b.load(1, phi.addr(neigh[f]), dep=j_n)
        b.load(3, g.addr(owner[f]), dep=j_o)
        b.store(3, g.addr(owner[f]), dep=j_o)
        b.load(3, g.addr(neigh[f]), dep=j_n)
        b.store(3, g.addr(neigh[f]), dep=j_n)
        b.next_iter()
    return b.build()


def perm_sort(n: int = 32_768, key_range: int = 8_192, seed: int = 2) -> Trace:
    """Graclus counting sort [35]: histogram + permutation write."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, size=n)
    # running positions, as the scatter pass would see them
    count = np.zeros(key_range, dtype=np.int64)

    b = _TraceBuilder("perm_sort", ii=2)
    key = b.array("key", n)
    cnt = b.array("count", key_range)
    out = b.array("out", n)

    # pass 1: count[key[i]]++
    for i in range(n):
        j_k = b.load(0, key.addr(i))
        b.load(1, cnt.addr(keys[i]), dep=j_k)
        b.store(1, cnt.addr(keys[i]), dep=j_k)
        b.next_iter()
    # pass 2 (prefix sum): regular sweep
    for k in range(key_range):
        b.load(2, cnt.addr(k))
        b.store(2, cnt.addr(k))
        b.next_iter()
    offsets = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=key_range))[:-1]])
    count[:] = offsets
    # pass 3: out[count[key[i]]++] = key[i]
    for i in range(n):
        j_k = b.load(0, key.addr(i))
        j_c = b.load(1, cnt.addr(keys[i]), dep=j_k)
        pos = count[keys[i]]
        count[keys[i]] += 1
        b.store(3, out.addr(pos), dep=j_c)
        b.store(1, cnt.addr(keys[i]), dep=j_k)
        b.next_iter()
    return b.build()


def radix_hist(n: int = 65_536, n_buckets: int = 2_048, shift: int = 8,
               seed: int = 3) -> Trace:
    """MachSuite radix sort (histogram): ``hist[(data[i] >> s) & mask]++``.

    The shift/AND imparts locality (the paper notes this explicitly, §4.4):
    the 256-entry histogram fits in a few cache lines.
    """
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << 30, size=n)
    bucket = (data >> shift) & (n_buckets - 1)

    b = _TraceBuilder("radix_hist", ii=2)
    d = b.array("data", n)
    h = b.array("hist", n_buckets)
    for i in range(n):
        j_d = b.load(0, d.addr(i))
        b.load(1, h.addr(bucket[i]), dep=j_d)
        b.store(1, h.addr(bucket[i]), dep=j_d)
        b.next_iter()
    return b.build()


def radix_update(n: int = 49_152, n_buckets: int = 1_024, shift: int = 8,
                 seed: int = 4) -> Trace:
    """MachSuite radix sort (update): scatter to ``out[offset[bucket]++]``."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 1 << 30, size=n)
    bucket = ((data >> shift) & (n_buckets - 1)).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(np.bincount(bucket, minlength=n_buckets))[:-1]])
    pos = offs.copy()

    b = _TraceBuilder("radix_update", ii=3)
    d = b.array("data", n)
    off = b.array("offset", n_buckets)
    out = b.array("out", n)
    for i in range(n):
        j_d = b.load(0, d.addr(i))
        j_o = b.load(1, off.addr(bucket[i]), dep=j_d)
        b.store(2, out.addr(pos[bucket[i]]), dep=j_o)
        pos[bucket[i]] += 1
        b.store(1, off.addr(bucket[i]), dep=j_d)
        b.next_iter()
    return b.build()


def rgb(n: int = 16_384, palette_size: int = 65_536, seed: int = 5) -> Trace:
    """MiBench: paletted colour -> RGB.  Random lookups in a 64k palette
    (among the most random kernels, §4.3)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, palette_size, size=n)

    b = _TraceBuilder("rgb", ii=2)
    src = b.array("indexed", n)
    pal = b.array("palette", palette_size)
    out = b.array("rgb_out", n)
    for i in range(n):
        j_i = b.load(0, src.addr(i))
        b.load(1, pal.addr(idx[i]), dep=j_i)
        b.store(2, out.addr(i))
        b.next_iter()
    return b.build()


def src2dest(n: int = 16_384, block: int = 64, seed: int = 6) -> Trace:
    """Berkeley multimedia audio copy through an index map.

    The map is a block permutation: runs of ``block`` sequential samples at
    permuted origins -> a regular/irregular *mix* (Fig. 7g/h)."""
    rng = np.random.default_rng(seed)
    n_blocks = n // block
    origins = rng.permutation(n_blocks) * block
    mapping = (origins[:, None] + np.arange(block)[None, :]).reshape(-1)

    b = _TraceBuilder("src2dest", ii=2)
    mp = b.array("map", n)
    src = b.array("src", n)
    dst = b.array("dst", n)
    for i in range(n):
        j_m = b.load(0, mp.addr(i))
        b.load(1, src.addr(mapping[i]), dep=j_m)
        b.store(2, dst.addr(i))
        b.next_iter()
    return b.build()


def random_access(n: int = 16_384, table_elems: int = 262_144,
                  seed: int = 7) -> Trace:
    """Pure-random gather over a 1 MiB table (reconfiguration control)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, table_elems, size=n)
    b = _TraceBuilder("random", ii=2)
    ind = b.array("indices", n)
    tab = b.array("table", table_elems)
    for i in range(n):
        j_i = b.load(0, ind.addr(i))
        b.load(1, tab.addr(idx[i]), dep=j_i)
        b.next_iter()
    return b.build()


#: kernel registry: name -> zero-arg constructor (paper defaults).
#: :mod:`repro_torch.core.cgra.workloads` extends this dict at import time with the
#: irregular-workload frontier families (BFS/PageRank, hash join, mesh
#: gather); the package ``__init__`` imports it, so any import of
#: ``repro_torch.core.cgra`` (or a submodule) sees the full registry.
KERNELS: dict[str, Callable[[], Trace]] = {
    "gcn_citeseer": lambda: gcn_aggregate("citeseer"),
    "gcn_cora": lambda: gcn_aggregate("cora"),
    "gcn_pubmed": lambda: gcn_aggregate("pubmed", max_edges=30_000),
    "gcn_ogbn_arxiv": lambda: gcn_aggregate("ogbn_arxiv", max_edges=30_000),
    "grad": grad,
    "perm_sort": perm_sort,
    "radix_hist": radix_hist,
    "radix_update": radix_update,
    "rgb": rgb,
    "src2dest": src2dest,
    "random": random_access,
}

#: kernels driven by real-dataset-statistics inputs vs randomly generated
#: inputs (the split used in §4.4 / Fig. 17).
REAL_DATA_KERNELS = ("gcn_citeseer", "gcn_cora", "gcn_pubmed", "gcn_ogbn_arxiv")
RANDOM_DATA_KERNELS = ("grad", "perm_sort", "radix_hist", "radix_update",
                       "rgb", "src2dest")
