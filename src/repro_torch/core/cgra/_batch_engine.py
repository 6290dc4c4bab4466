"""A copy of ``repro.core.cgra._batch_engine`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).  The tests the text below
names are the reference's.

Lane-parallel batched simulation engine: B configs over one trace per pass.

Sweeping a paper figure means running *many* :class:`SimConfig` points over
one kernel trace.  The scalar engine (:mod:`._engine`) walks the trace once
per point; this module restructures the computation around the shared data —
the access stream — so a whole batch of configurations ("lanes") advances
together:

* **Content phase** (`_ContentGroup`): for lanes that share an L1 shape
  (``spm_bytes``, ``n_caches``, per-cache geometry) the L1 hit/miss stream is
  *timing-independent* — MSHR pressure and DRAM latency delay fills but never
  change which line is resident when (LRU order is touch order, and every
  miss installs).  One ordered-dict LRU pass over the trace therefore
  produces, for every lane in the group at once: the hit/miss counts and the
  compressed **event list** — L1 misses plus the first load hit on each line
  whose latest fill was issued by a non-stalling store miss (the only hits
  that can partial-wait on an in-flight fill; a load miss stalls the array
  until its fill returns, so nothing later can wait on it).

* **Timing replay** (`_replay`): each lane then replays only the events
  (typically 3-30x fewer than accesses) against its own timing state —
  per-cache :class:`~._engine._Mshr` ready-heaps, the shared-L2 recency
  dicts, the :class:`~._engine._DramBus` recurrence — with the stall-free
  cycle of every iteration precomputed as one ``cumsum`` (``base``), so
  all-SPM / all-hit iteration runs are bulk-advanced instead of stepped.

* **SPM-only fast path** (`_spm_only_lane`): with no caches, every non-SPM
  load stalls until its word-wide DRAM transaction returns, which collapses
  the walk into a running-max recurrence over bus segments; it is evaluated
  with vectorized ``maximum.reduceat`` per lane — no Python per-access loop.

* **Runahead routing**: runahead couples timing to cache content (prefetch
  decisions depend on stall windows), so runahead lanes are delegated to
  the columnar lane-lockstep runahead engine (:mod:`._runahead_engine`),
  one group per L1 shape.  Results are merged back in lane order.

Everything here is pinned **bit-identical** to the scalar engine by
`tests/test_sweep.py` (full-``Stats`` parity over the Table-3 grid x paper
kernels) — the scalar walk stays the golden reference.

The content-phase LRU is also exported stand-alone (:func:`lru_hit_series`,
:func:`lru_miss_counts`) — the latter evaluates the whole (ways x line-size)
profiling grid of §3.4 with one capped LRU-stack pass per line size (hits
for *every* associativity fall out of one stack-distance histogram), which
is what the reference's ``reconfig`` profiles with (the port's
:mod:`.reconfig` profiles with :mod:`.cache_grid` instead).
"""
from __future__ import annotations

from bisect import bisect_right as _bisect_right, insort as _insort

import numpy as np

from . import _engine
from .trace import Trace


# ---------------------------------------------------------------------------
# Stand-alone LRU primitives (content model; pinned to cache.OracleCache)
# ---------------------------------------------------------------------------

def lru_hit_series(addrs, line: int, n_sets: int, n_ways: int) -> np.ndarray:
    """Per-access hit booleans of one LRU set-associative cache.

    Same semantics as :class:`repro_torch.core.cgra.cache.OracleCache` (and the
    jaxcache scan): allocate on miss, LRU by last touch.
    """
    addrs = np.asarray(addrs, dtype=np.int64)
    out = np.zeros(len(addrs), dtype=bool)
    if n_ways <= 0:
        return out
    lines = addrs // line
    sets = [dict() for _ in range(n_sets)]
    for i, (s, t) in enumerate(zip((lines % n_sets).tolist(),
                                   (lines // n_sets).tolist())):
        d = sets[s]
        if t in d:
            del d[t]                      # move to MRU
            d[t] = None
            out[i] = True
        else:
            if len(d) >= n_ways:
                del d[next(iter(d))]
            d[t] = None
    return out


def lru_miss_counts(addrs, way_options, line_options,
                    way_bytes: int) -> np.ndarray:
    """``[len(way_options), len(line_options)]`` miss counts for the §3.4
    profiling grid, via capped LRU stack distances.

    For a fixed line size (hence fixed set count ``way_bytes // line``), the
    LRU stack property makes hit/miss for *every* associativity a threshold
    on one per-access stack distance, so a single pass with a stack capped at
    ``max(way_options)`` yields the whole ways axis as a histogram.
    """
    addrs = np.asarray(addrs, dtype=np.int64)
    way_options = list(way_options)
    max_w = max(way_options) if way_options else 0
    out = np.empty((len(way_options), len(line_options)), dtype=np.int64)
    total = len(addrs)
    for li, line in enumerate(line_options):
        if max_w <= 0 or total == 0:
            out[:, li] = total
            continue
        n_sets = max(1, way_bytes // line)
        lines = addrs // line
        hist = np.zeros(max_w, dtype=np.int64)   # hits at stack distance d
        stacks = [[] for _ in range(n_sets)]     # MRU last, len <= max_w
        for s, t in zip((lines % n_sets).tolist(),
                        (lines // n_sets).tolist()):
            st = stacks[s]
            try:
                p = st.index(t)
            except ValueError:
                if len(st) >= max_w:
                    del st[0]
                st.append(t)
                continue
            hist[len(st) - 1 - p] += 1
            del st[p]
            st.append(t)
        hits_le = np.cumsum(hist)                # hits with distance < W
        for wi, w in enumerate(way_options):
            out[wi, li] = total - (hits_le[w - 1] if w > 0 else 0)
    return out


# ---------------------------------------------------------------------------
# Demand-path lanes: shared content phase + per-lane timing replay
# ---------------------------------------------------------------------------

_MISSING = object()


def _group_key(cfg):
    """Lanes with equal keys share one content phase (timing-only diffs)."""
    return (cfg.spm_bytes, cfg.n_caches,
            tuple((c.ways, c.line, c.way_bytes) for c in cfg.l1_configs()))


class _ContentGroup:
    """The timing-independent structure of one (trace, L1-shape) group."""

    def __init__(self, trace: Trace, cfg):
        self.trace = trace
        n_caches = cfg.n_caches
        l1cfgs = cfg.l1_configs()
        self.l1_line = [c.line for c in l1cfgs]

        act = trace.active_index(cfg.spm_bytes)
        cache_idx = trace.cache_index(n_caches)[act]
        lines_c = np.asarray(self.l1_line, dtype=np.int64)
        sets_c = np.asarray([c.sets for c in l1cfgs], dtype=np.int64)
        line = trace.addr[act] // lines_c[cache_idx]
        nset = sets_c[cache_idx]
        ways_c = [c.ways for c in l1cfgs]
        set_l = (line % nset).tolist()
        tag_l = (line // nset).tolist()
        store_l = trace.is_store[act].tolist()

        # Per-set dicts: insertion order is the LRU order; the value is the
        # event id of the store-miss that filled the line while no load has
        # hit it yet (the partial-wait marker), else None.  The marker lives
        # inside the entry so eviction retires it for free.
        l1_sets = [[{} for _ in range(c.sets)] for c in l1cfgs]
        ev_pos: list[int] = []    # position (within act) of the event
        ev_ref: list[int] = []    # >= 0: partial-wait on that miss event
        missing = _MISSING
        cache_l = cache_idx.tolist() if n_caches > 1 else None
        if cache_l is None:
            d_sets = l1_sets[0]
            w0 = ways_c[0]
            k = 0
            for s, t, st in zip(set_l, tag_l, store_l):
                d = d_sets[s]
                v = d.pop(t, missing)
                if v is not missing:
                    if v is not None and not st:
                        ev_pos.append(k)  # first load hit on an in-flight
                        ev_ref.append(v)  # store-miss fill: may stall
                        v = None
                    d[t] = v              # reinsert at MRU
                elif w0:
                    # marker: event id while a store-miss fill is unwaited
                    marker = len(ev_pos) if st else None
                    ev_pos.append(k)
                    ev_ref.append(-1)
                    if len(d) >= w0:
                        d.pop(next(iter(d)))
                    d[t] = marker
                else:
                    ev_pos.append(k)
                    ev_ref.append(-1)
                k += 1
        else:
            k = 0
            for s, t, st in zip(set_l, tag_l, store_l):
                c = cache_l[k]
                d = l1_sets[c][s]
                v = d.pop(t, missing)
                if v is not missing:
                    if v is not None and not st:
                        ev_pos.append(k)
                        ev_ref.append(v)
                        v = None
                    d[t] = v
                else:
                    marker = len(ev_pos) if st else None
                    ev_pos.append(k)
                    ev_ref.append(-1)
                    w = ways_c[c]
                    if w > 0:
                        if len(d) >= w:
                            d.pop(next(iter(d)))
                        d[t] = marker
                k += 1

        self.n_caches = n_caches
        self.spm_accesses = int(len(trace) - act.size)
        ev_pos_arr = np.asarray(ev_pos, dtype=np.int64)
        ev_ref_arr = np.asarray(ev_ref, dtype=np.int64)
        is_miss = ev_ref_arr < 0
        # partial-wait events are load hits, so is_store is False for them
        ev_is_store = trace.is_store[act[ev_pos_arr]]
        n_misses = int(np.count_nonzero(is_miss))
        self.l1_hits = int(act.size) - n_misses
        self.l1_misses = n_misses
        self.uncovered = int(np.count_nonzero(is_miss & ~ev_is_store))
        self.ev_iter = trace.iter_index()[act[ev_pos_arr]].tolist()
        self.ev_line = line[ev_pos_arr].tolist()
        self.ev_c = (cache_idx[ev_pos_arr].tolist() if n_caches > 1
                     else [0] * len(ev_pos))
        self.ev_store = ev_is_store.tolist()
        self.ev_ref = ev_ref
        self.base = np.cumsum(
            trace.arbitration_extra(cfg.spm_bytes, n_caches)
            + trace.ii).tolist()

    def replay(self, cfg, stats) -> None:
        """Advance one lane's timing state through the event list.

        The MSHR ready-heaps are kept as sorted lane-local lists with the
        :class:`~._engine._Mshr` protocol inlined (lazy prune only once a
        heap could actually be full), and the DRAM-bus recurrence is two
        locals; both are semantically identical to the scalar classes.
        """
        base = self.base
        entries = cfg.mshr
        mshr_heaps: list[list[int]] = [[] for _ in range(self.n_caches)]
        bus_latency = cfg.dram_latency
        bus_last = -10**18
        l1_line = self.l1_line
        l2_on = cfg.l2 is not None
        if l2_on:
            l2_line = cfg.l2.line
            l2_nsets = cfg.l2.sets
            l2_ways = cfg.l2.ways
            l2_hit_lat = cfg.l2_hit_latency
            l2_sets: list[dict] = [{} for _ in range(l2_nsets)]
            l2_occ = max(1, l2_line // max(1, cfg.dram_bus_bytes_per_cycle))
        else:
            bpc = max(1, cfg.dram_bus_bytes_per_cycle)
            l1_occ = [max(1, ln // bpc) for ln in l1_line]
        bisect_right, insort = _bisect_right, _insort
        l2_hits = dram = stall = 0
        S = 0                              # accumulated stall offset
        fills = [0] * len(self.ev_c)
        for k, (t, c, ln, st, ref) in enumerate(zip(
                self.ev_iter, self.ev_c, self.ev_line, self.ev_store,
                self.ev_ref)):
            now = base[t] + S
            if ref >= 0:                   # load hit on an in-flight fill
                r = fills[ref]
                if r > now:
                    stall += r - now
                    S = r - base[t]
                continue
            rl = mshr_heaps[c]
            if len(rl) >= entries:         # stall here if MSHR exhausted
                i = bisect_right(rl, now)
                if i:
                    del rl[:i]
                issue = now if len(rl) < entries else rl[len(rl) - entries]
            else:
                issue = now
            if l2_on:
                l2l = (ln * l1_line[c]) // l2_line
                d2 = l2_sets[l2l % l2_nsets]
                tg2 = l2l // l2_nsets
                r2 = d2.get(tg2)
                if r2 is not None and r2 <= issue:
                    del d2[tg2]            # touch: move to MRU
                    d2[tg2] = r2
                    l2_hits += 1
                    fill = issue + l2_hit_lat
                else:
                    dram += 1
                    fill = issue + bus_latency
                    if fill < bus_last + l2_occ:
                        fill = bus_last + l2_occ
                    bus_last = fill
                    if r2 is not None:     # refresh the in-flight line
                        del d2[tg2]
                    elif len(d2) >= l2_ways:
                        del d2[next(iter(d2))]
                    d2[tg2] = fill
            else:
                dram += 1
                fill = issue + bus_latency
                if fill < bus_last + l1_occ[c]:
                    fill = bus_last + l1_occ[c]
                bus_last = fill
            if rl and fill < rl[-1]:
                insort(rl, fill)
            else:
                rl.append(fill)
            fills[k] = fill
            ready = issue if st else fill  # store buffer absorbs the miss
            if ready > now:
                stall += ready - now
                S = ready - base[t]
        stats.cycles = (base[-1] + S) if base else 0
        stats.stall_cycles = stall
        stats.spm_accesses = self.spm_accesses
        stats.l1_hits = self.l1_hits
        stats.l1_misses = self.l1_misses
        stats.l2_hits = l2_hits
        stats.dram_accesses = dram
        stats.uncovered_misses = self.uncovered


# ---------------------------------------------------------------------------
# SPM-only lanes: running-max recurrence, no per-access loop
# ---------------------------------------------------------------------------

def _spm_only_lane(trace: Trace, cfg, stats) -> None:
    """Vectorized SPM-only baseline (bit-identical to the scalar loop).

    Every non-SPM access is a word-wide DRAM transaction; loads always stall
    (``ready >= now + latency``), so the cycle counter equals the stall-free
    schedule plus the bus backlog at the last load.  Between consecutive
    loads the bus recurrence ``r_k = max(now_k + L, r_{k-1} + occ)`` unrolls
    into a segmented running max, evaluated with one ``maximum.reduceat``.
    """
    n_iters = len(trace.iter_starts()) - 1
    ii = trace.ii
    stats.compute_cycles = n_iters * ii
    act = trace.active_index(cfg.spm_bytes)
    stats.spm_accesses = int(len(trace) - act.size)
    stats.dram_accesses = int(act.size)
    if act.size == 0:
        stats.cycles = n_iters * ii
        return
    latency = cfg.dram_latency
    occ = max(1, 4 // max(1, cfg.dram_bus_bytes_per_cycle))
    # stall-free cycle at each active access; positions index the bus chain
    a = (trace.iter_index()[act] + 1) * ii
    is_load = ~trace.is_store[act]
    load_pos = np.flatnonzero(is_load)
    if load_pos.size == 0:
        stats.cycles = n_iters * ii
        return
    p = np.arange(act.size, dtype=np.int64)
    g = a + latency - p * occ
    last = int(load_pos[-1])
    seg_starts = np.concatenate(([0], load_pos[:-1] + 1))
    segmax = np.maximum.reduceat(g[:last + 1], seg_starts)
    lp = load_pos.astype(np.int64)
    r = int(segmax[0] + lp[0] * occ)       # first segment: empty bus
    if load_pos.size > 1:
        a_prev = a[lp[:-1]]
        contrib = np.maximum(segmax[1:] - a_prev + lp[1:] * occ,
                             (lp[1:] - lp[:-1]) * occ)
        r += int(contrib.sum())
    stall = r - int(a[last])
    stats.stall_cycles = stall
    stats.cycles = n_iters * ii + stall


# ---------------------------------------------------------------------------
# Batch entry point
# ---------------------------------------------------------------------------

def run_batch(trace: Trace, cfgs, stats_list, diags: list | None = None) \
        -> list[str]:
    """Simulate every config in ``cfgs`` over ``trace``, mutating the
    matching ``stats_list`` entries.  Returns the per-lane engine tag
    (``"batched"`` or ``"runahead"``) for reporting.

    ``diags``, when given, must be a list of ``len(cfgs)`` slots; runahead
    lanes receive their engine diagnostics (the first lane of a lockstep
    group carries the group's lockstep/microstep counters, see
    :func:`repro_torch.core.cgra._runahead_engine.run_group`).
    """
    tags = ["batched"] * len(cfgs)
    groups: dict[tuple, list[int]] = {}
    ra_groups: dict[tuple, list[int]] = {}
    for i, cfg in enumerate(cfgs):
        if cfg.spm_only:
            _spm_only_lane(trace, cfg, stats_list[i])
        elif cfg.runahead:
            # prefetch content depends on stall timing: the runahead engine
            # advances such a group's lanes in columnar lockstep
            ra_groups.setdefault(_group_key(cfg), []).append(i)
            tags[i] = "runahead"
        else:
            groups.setdefault(_group_key(cfg), []).append(i)
    for idxs in groups.values():
        group = _ContentGroup(trace, cfgs[idxs[0]])
        for i in idxs:
            stats_list[i].compute_cycles = \
                (len(trace.iter_starts()) - 1) * trace.ii
            group.replay(cfgs[i], stats_list[i])
    if ra_groups:
        from . import _runahead_engine

        for idxs in ra_groups.values():
            group_diags = _runahead_engine.run_group(
                trace, [cfgs[i] for i in idxs],
                [stats_list[i] for i in idxs])
            if diags is not None:
                for i, d in zip(idxs, group_diags):
                    diags[i] = d
    return tags
