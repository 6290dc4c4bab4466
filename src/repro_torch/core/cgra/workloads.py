"""A copy of ``repro.core.cgra.workloads`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).  The tests the text below
names are the reference's.

Irregular-workload trace generators beyond the paper's Table-1 suite.

The paper motivates the cache + runahead architecture with three workload
domains the SPM-only model cannot serve — graph analytics, irregular
database operations, and unstructured-mesh HPC — yet evaluates only its own
seven kernel families.  This module generates parameterized traces for those
motivating domains, so the sweep can report where runahead and cache
reconfiguration win (or lose) *beyond* the paper's selection:

* **Frontier expansion** (:func:`bfs_frontier`, :func:`pagerank_push`) —
  level-synchronous BFS and push-style PageRank over power-law graphs
  (reusing :func:`repro_torch.core.cgra.trace._powerlaw_graph`).  BFS carries a
  *two-level* address-dependence chain per edge (frontier value -> row
  pointer -> neighbour id -> distance address), the deepest chains in the
  suite; hub destinations give the runahead walker both dummy-propagation
  pressure and prefetch reuse.
* **Hash join** (:func:`hash_join`) — build/probe with tunable key skew and
  collision-chain walks.  Probe iterations pointer-chase bucket chains:
  every chain step's address comes from the previous step's load, so stall
  windows expose long serial dependence chains (deep MSHR pressure, little
  for the walker to run ahead *past* — the adversarial case for §3.2).
* **Unstructured-mesh gather** (:func:`mesh_gather`) — face-neighbour
  gathers over a perturbed 2D mesh with *reorderable* node numberings:
  ``rcm`` (reverse Cuthill-McKee, bandwidth-minimized -> neighbour locality)
  vs ``shuffled`` (locality destroyed).  The pair isolates how much of the
  cache win is data layout rather than hardware.

All generators emit :class:`~repro_torch.core.cgra.trace.Trace` objects through
the existing :class:`~repro_torch.core.cgra.trace._TraceBuilder`, with
``addr_dep`` chains pointing at the address-producing *loads* exactly as the
Table-1 generators do, and register in
:data:`repro_torch.core.cgra.trace.KERNELS` (default-size entries listed in
:data:`FRONTIER_KERNELS`; ``benchmarks/fig18_frontier.py`` sweeps them).

The module also hosts :func:`random_trace`, the structurally-valid
arbitrary-trace generator behind the cross-engine differential fuzz harness
(``tests/test_engine_differential.py``): the frontier traces deliberately
push engine paths the paper kernels barely touch, and the fuzzer is what
makes that safe — scalar == batched == runahead equality is asserted over
the whole trace space, not just the curated kernel grid.
"""
from __future__ import annotations

import numpy as np

from .trace import (KERNELS, Trace, _TraceBuilder, _powerlaw_graph)

__all__ = [
    "FRONTIER_KERNELS", "bfs_frontier", "pagerank_push", "hash_join",
    "mesh_gather", "random_trace",
]


# ---------------------------------------------------------------------------
# Graph analytics: frontier expansion over power-law graphs
# ---------------------------------------------------------------------------

def bfs_frontier(n_nodes: int = 4096, n_edges: int = 24_576,
                 alpha: float = 1.5, seed: int = 11,
                 max_edges: int | None = 20_000) -> Trace:
    """Level-synchronous BFS: expand the frontier over a power-law graph.

    One iteration per processed edge ``(u, v)`` with ``u`` read from the
    frontier queue:

    * load ``frontier[fi]`` (sequential queue scan — regular),
    * load ``row_ptr[u]`` through the frontier value (dep level 1),
    * load ``col_idx[e]`` through the row-pointer value (dep level 2),
    * load ``dist[v]`` through the neighbour id (dep level 3),
    * on first visit: store ``dist[v]`` and append ``v`` to the queue.

    The three-deep ``addr_dep`` chain is the deepest in the trace suite —
    a runahead walker that goes dummy at level 1 loses the whole edge, so
    coverage hinges on the frontier scan staying concrete.  The frontier
    itself expands hub-first (power-law degrees), so early levels flood the
    MSHRs while late levels trickle.
    """
    rng = np.random.default_rng(seed)
    src, dst = _powerlaw_graph(n_nodes, n_edges, rng, alpha=alpha)
    # symmetrize: BFS traverses the graph as undirected (as the Graph500 /
    # GAP benchmarks do), else the hub's reachable component is tiny and
    # the frontier never expands
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    order = np.argsort(u, kind="stable")
    u, dst = u[order], v[order]
    n_edges = len(dst)
    indptr = np.concatenate(
        ([0], np.cumsum(np.bincount(u, minlength=n_nodes)))).astype(np.int64)

    b = _TraceBuilder("bfs_frontier", ii=2)
    frontier = b.array("frontier", n_nodes)
    row_ptr = b.array("row_ptr", n_nodes + 1)
    col_idx = b.array("col_idx", n_edges)
    dist = b.array("dist", n_nodes)

    # run the actual BFS (from the highest-degree node: the frontier
    # genuinely expands, then drains) while emitting the trace
    source = int(np.argmax(np.diff(indptr)))
    seen = np.zeros(n_nodes, dtype=bool)
    seen[source] = True
    queue = [source]
    head, emitted = 0, 0
    budget = max_edges if max_edges is not None else n_edges
    while head < len(queue) and emitted < budget:
        u = queue[head]
        for e in range(int(indptr[u]), int(indptr[u + 1])):
            if emitted >= budget:
                break
            v = int(dst[e])
            j_f = b.load(0, frontier.addr(head))
            j_p = b.load(1, row_ptr.addr(u), dep=j_f)
            j_c = b.load(1, col_idx.addr(e), dep=j_p)
            b.load(2, dist.addr(v), dep=j_c)
            if not seen[v]:
                seen[v] = True
                b.store(2, dist.addr(v), dep=j_c)
                # queue append: the tail address is a sequential counter
                b.store(3, frontier.addr(len(queue)))
                queue.append(v)
            b.next_iter()
            emitted += 1
        head += 1
    return b.build()


def pagerank_push(n_nodes: int = 3072, n_edges: int = 18_432,
                  alpha: float = 1.5, seed: int = 12,
                  max_edges: int | None = 16_000) -> Trace:
    """Push-style PageRank sweep: scatter each node's rank to its targets.

    One iteration per edge ``(u, v)``, ``u`` ascending (a full-node sweep —
    the dense-frontier regime of frontier expansion):

    * load ``row_ptr[u]`` and ``rank[u]`` (sequential — regular),
    * load ``col_idx[e]`` through the row-pointer value,
    * read-modify-write ``accum[v]`` through the neighbour id.

    The scatter destination follows the graph's power law: hub rows are hit
    from everywhere (cache reuse the paper's `gcn` also shows), while the
    tail is effectively random.  Unlike BFS the regular streams dominate
    the access count, so this family sits *between* the paper's regular and
    irregular extremes.
    """
    rng = np.random.default_rng(seed)
    src, dst, indptr = _powerlaw_graph(n_nodes, n_edges, rng,
                                       alpha=alpha, csr=True)

    b = _TraceBuilder("pagerank_push", ii=2)
    row_ptr = b.array("row_ptr", n_nodes + 1)
    col_idx = b.array("col_idx", n_edges)
    rank = b.array("rank", n_nodes)
    accum = b.array("accum", n_nodes)

    budget = max_edges if max_edges is not None else n_edges
    emitted = 0
    for u in range(n_nodes):
        if emitted >= budget:
            break
        for e in range(int(indptr[u]), int(indptr[u + 1])):
            if emitted >= budget:
                break
            v = int(dst[e])
            j_p = b.load(0, row_ptr.addr(u))
            b.load(0, rank.addr(u))
            j_c = b.load(1, col_idx.addr(e), dep=j_p)
            b.load(3, accum.addr(v), dep=j_c)
            b.store(3, accum.addr(v), dep=j_c)
            b.next_iter()
            emitted += 1
    return b.build()


# ---------------------------------------------------------------------------
# Irregular database operations: hash join build/probe
# ---------------------------------------------------------------------------

def hash_join(n_build: int = 2048, n_probe: int = 4096,
              n_buckets: int = 512, skew: float = 1.2, seed: int = 13,
              max_chain: int = 8) -> Trace:
    """Hash join: chained-bucket build phase + pointer-chasing probe phase.

    Build (one iteration per build tuple): load the key (regular), load the
    bucket head through it, link the tuple in at the head (stores through
    the dependent addresses).  Probe (one iteration per probe tuple): load
    the probe key, load the bucket head through it, then *walk the collision
    chain* — each step loads the candidate key and the next-pointer through
    the previous step's load, a serial ``addr_dep`` chain up to
    ``max_chain`` deep inside a single II window.

    ``skew`` > 0 draws probe keys Zipf-distributed over the build keys
    (hot keys -> hot buckets -> long, cache-resident chains); ``skew`` = 0
    probes uniformly over twice the build-key range, so half the probes
    miss entirely (short walks, cold buckets).  ``n_build / n_buckets``
    sets the expected chain length — the knob for dependence-chain depth
    and MSHR pressure.
    """
    if skew < 0 or (0 < skew <= 1.0):
        raise ValueError("skew must be 0 (uniform) or > 1 (Zipf exponent)")
    rng = np.random.default_rng(seed)
    key_space = 2 * n_build
    build_keys = rng.permutation(key_space)[:n_build]
    if skew:
        # Zipf rank over the build keys: rank r -> r-th build key (hot keys
        # are real keys, so skewed probes mostly *hit*)
        ranks = rng.zipf(skew, size=n_probe) % n_build
        probe_keys = build_keys[ranks]
    else:
        probe_keys = rng.integers(0, key_space, size=n_probe)

    b = _TraceBuilder("hash_join", ii=2)
    bkey = b.array("build_key", n_build)
    head = b.array("bucket_head", n_buckets)
    nxt = b.array("next_ptr", n_build)
    pay = b.array("payload", n_build)
    pkey = b.array("probe_key", n_probe)
    out = b.array("join_out", n_probe)

    # software model of the chained hash table (head insertion)
    heads = np.full(n_buckets, -1, dtype=np.int64)
    links = np.full(n_build, -1, dtype=np.int64)

    # build phase
    for i in range(n_build):
        h = int(build_keys[i]) % n_buckets
        j_k = b.load(0, bkey.addr(i))
        j_h = b.load(1, head.addr(h), dep=j_k)
        b.store(2, nxt.addr(i), dep=j_h)      # next[i] = old head
        b.store(1, head.addr(h), dep=j_k)     # head = i
        links[i] = heads[h]
        heads[h] = i
        b.next_iter()

    # probe phase
    for i in range(n_probe):
        k = int(probe_keys[i])
        h = k % n_buckets
        j_k = b.load(0, pkey.addr(i))
        j_prev = b.load(1, head.addr(h), dep=j_k)
        cur = int(heads[h])
        steps = 0
        while cur >= 0 and steps < max_chain:
            j_c = b.load(2, bkey.addr(cur), dep=j_prev)   # key compare
            if int(build_keys[cur]) == k:
                b.load(3, pay.addr(cur), dep=j_c)
                b.store(3, out.addr(i))
                break
            j_prev = b.load(2, nxt.addr(cur), dep=j_prev)  # pointer chase
            cur = int(links[cur])
            steps += 1
        b.next_iter()
    return b.build()


# ---------------------------------------------------------------------------
# Unstructured-mesh HPC: face-neighbour gathers, reorderable numbering
# ---------------------------------------------------------------------------

def _mesh_edges(nx: int, ny: int, extra_frac: float,
                rng: np.random.Generator) -> np.ndarray:
    """Edge list of a perturbed 2D mesh: the structured 4-neighbour grid
    plus ``extra_frac`` random long-range edges (what makes it behave like
    an *unstructured* mesh: a pure grid renumbers perfectly)."""
    ids = np.arange(nx * ny).reshape(ny, nx)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    edges = [right, down]
    n_extra = int(extra_frac * (len(right) + len(down)))
    if n_extra:
        ab = rng.integers(0, nx * ny, size=(n_extra, 2))
        edges.append(ab[ab[:, 0] != ab[:, 1]])
    return np.concatenate(edges, axis=0)


def _rcm_order(n_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee: BFS from a minimum-degree node, neighbours in
    increasing-degree order, then reverse.  Returns ``order`` with
    ``order[old_id] = new_id``."""
    adj: list[list[int]] = [[] for _ in range(n_nodes)]
    for a, b in edges:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    deg = np.array([len(a) for a in adj])
    visited = np.zeros(n_nodes, dtype=bool)
    seq: list[int] = []
    # min-degree start per component (random extras keep the grid connected,
    # but isolated nodes are still possible)
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        head = 0
        while head < len(queue):
            u = queue[head]
            head += 1
            seq.append(u)
            for v in sorted(set(adj[u]), key=lambda w: (deg[w], w)):
                if not visited[v]:
                    visited[v] = True
                    queue.append(v)
    order = np.empty(n_nodes, dtype=np.int64)
    order[np.array(seq[::-1], dtype=np.int64)] = np.arange(n_nodes)
    return order


def mesh_gather(nx: int = 56, ny: int = 56, numbering: str = "rcm",
                extra_frac: float = 0.15, seed: int = 14) -> Trace:
    """Unstructured-mesh face-neighbour gather under a chosen numbering.

    Per face (one iteration): load the two endpoint node ids (regular face
    streams), gather both nodes' field values through them, and
    read-modify-write both nodes' accumulators — the ``grad``-style OpenFOAM
    pattern, but with the node *numbering* as an axis:

    * ``"rcm"``      — reverse Cuthill-McKee (bandwidth-minimized: a face's
      two nodes get nearby ids -> the gathers share cache lines),
    * ``"natural"``  — row-major grid order (good for the structured part,
      blind to the long-range edges),
    * ``"shuffled"`` — random permutation (locality destroyed; the same
      mesh becomes one of the most irregular traces in the suite).

    Faces are visited sorted by their lower renumbered endpoint (mesh
    iteration order follows the numbering, as OpenFOAM's owner ordering
    does), so the numbering steers *both* the gather addresses and the
    sweep order.
    """
    rng = np.random.default_rng(seed)
    n_nodes = nx * ny
    edges = _mesh_edges(nx, ny, extra_frac, rng)
    if numbering == "rcm":
        order = _rcm_order(n_nodes, edges)
    elif numbering == "natural":
        order = np.arange(n_nodes, dtype=np.int64)
    elif numbering == "shuffled":
        order = rng.permutation(n_nodes).astype(np.int64)
    else:
        raise ValueError(f"unknown numbering {numbering!r}")
    faces = order[edges]                       # relabel endpoints
    faces = np.sort(faces, axis=1)             # owner = lower id
    faces = faces[np.lexsort((faces[:, 1], faces[:, 0]))]

    b = _TraceBuilder(f"mesh_{numbering}", ii=3)
    f0 = b.array("face_n0", len(faces))
    f1 = b.array("face_n1", len(faces))
    phi = b.array("phi", n_nodes)
    acc = b.array("acc", n_nodes)

    for f in range(len(faces)):
        na, nb = int(faces[f, 0]), int(faces[f, 1])
        j_a = b.load(0, f0.addr(f))
        j_b = b.load(1, f1.addr(f))
        b.load(0, phi.addr(na), dep=j_a)
        b.load(1, phi.addr(nb), dep=j_b)
        b.load(2, acc.addr(na), dep=j_a)
        b.store(2, acc.addr(na), dep=j_a)
        b.load(3, acc.addr(nb), dep=j_b)
        b.store(3, acc.addr(nb), dep=j_b)
        b.next_iter()
    return b.build()


# ---------------------------------------------------------------------------
# Structurally-valid random traces (the differential fuzz generator)
# ---------------------------------------------------------------------------

def random_trace(seed: int = 0, *, max_arrays: int = 4, max_elems: int = 192,
                 max_iters: int = 48, max_per_iter: int = 6,
                 p_store: float = 0.3, p_dep: float = 0.45,
                 p_seq: float = 0.5, dep_window: int = 12,
                 n_pes: int = 8) -> Trace:
    """An arbitrary small trace with valid structure, seeded by ``seed``.

    The generator samples the whole space the engines must agree on, not
    just shapes the curated kernels happen to produce.  Structural
    invariants (the `Trace` contract the engines rely on):

    * every address lies inside a declared :class:`Array`
      (``plan_spm``'s array search requires it),
    * ``addr_dep`` is ``-1`` or the index of an earlier **load** —
      including loads from *earlier iterations* and SPM-resident loads,
      which the paper kernels never emit but the contract allows,
    * ``iter_id`` is non-decreasing with at least one access per iteration.

    Everything else — mixed sequential/random index streams (``p_seq``),
    store density, dependence density and reach (``dep_window``), PE
    spread, II — is drawn per trace, so hundreds of seeds cover regular
    streams, pure pointer chases, store-only iterations, single-access
    traces, and every mix between.
    """
    rng = np.random.default_rng(seed)
    ii = int(rng.integers(1, 5))
    b = _TraceBuilder(f"fuzz_{seed}", ii=ii)
    arrays = [b.array(f"a{k}", int(rng.integers(1, max_elems + 1)))
              for k in range(int(rng.integers(1, max_arrays + 1)))]
    cursors = [0] * len(arrays)
    n_iters = int(rng.integers(1, max_iters + 1))
    load_idx: list[int] = []      # indices of emitted loads (dep targets)
    for _ in range(n_iters):
        for _ in range(int(rng.integers(1, max_per_iter + 1))):
            k = int(rng.integers(0, len(arrays)))
            n_elems = arrays[k].size // 4
            if rng.random() < p_seq:
                idx = cursors[k] % n_elems
                cursors[k] += 1
            else:
                idx = int(rng.integers(0, n_elems))
            dep = -1
            if load_idx and rng.random() < p_dep:
                lo = max(0, len(load_idx) - dep_window)
                dep = load_idx[int(rng.integers(lo, len(load_idx)))]
            pe = int(rng.integers(0, n_pes))
            if rng.random() < p_store:
                b.store(pe, arrays[k].addr(idx), dep=dep)
            else:
                load_idx.append(b.load(pe, arrays[k].addr(idx), dep=dep))
        b.next_iter()
    return b.build()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

#: default-size frontier entries (what ``benchmarks/fig18_frontier.py``
#: sweeps); three workload families, with the knobs that matter as axes
FRONTIER_KERNELS = ("bfs_powerlaw", "pagerank_push", "hash_join_skew",
                    "hash_join_uniform", "mesh_rcm", "mesh_shuffled")

KERNELS.update({
    "bfs_powerlaw": bfs_frontier,
    "pagerank_push": pagerank_push,
    "hash_join_skew": lambda: hash_join(skew=1.2),
    "hash_join_uniform": lambda: hash_join(skew=0.0),
    "mesh_rcm": lambda: mesh_gather(numbering="rcm"),
    "mesh_shuffled": lambda: mesh_gather(numbering="shuffled"),
})
