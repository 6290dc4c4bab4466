"""A copy of ``repro.core.cgra._runahead_engine`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).  The tests the text below
names are the reference's.

Columnar lane-lockstep runahead engine.

Runahead execution (§3.2) couples cache *content* to stall *timing* — the
walker's prefetch decisions depend on when each lane stalls and for how
long — so the batched engine's shared content phase (:mod:`._batch_engine`)
cannot cover runahead lanes.  A speculate-and-repair structure that shared
a reference walk across lanes ran into this: the sweeps
that matter most (MSHR pressure, fig 13/14) diverge in the very first
pressure window, collapsing every follower to an independent scalar walk
that re-reads every trace column and re-decides every skip predicate the
other lanes just decided.

This engine abandons speculation and restructures the computation as a
**columnar lockstep advance** over shared trace columns:

* **Shared trace columns.**  All timing-independent per-access data — the
  demand and walker work lists, iteration bases, and the per-geometry
  (flat-set, tag, line, cache) columns (``Trace.geometry_lists``) — is
  computed once per (trace, spm, n_caches, L1-geometry) group and read
  once per op for the whole group.  The *flat set* index concatenates all
  caches' sets into one axis, so both hot loops address L1 state with a
  single precomputed subscript and no per-access cache indirection.

* **Per-lane state, lane-major.**  Each lane owns its machine state: the
  flat per-set L1 dicts (insertion order == LRU order, entry ==
  ``[fill, pf_unused, pf_id]`` exactly as the golden engine keeps them),
  MSHR ready-heaps, L2 recency dicts, DRAM-bus recurrence, prefetch
  ledger, and stall clock.  The lockstep stepper advances every lane of
  the group through one op before moving to the next, so the column
  reads, branch structure, and skip predicates are paid once per op
  instead of once per (op, lane).

* **Lane-mask predicates.**  Window-local predicates that the scalar
  walker tracks with per-lane Python sets become *lane bitmasks*:
  ``dummy`` maps a trace index to the mask of lanes whose dummy bit is
  set, ``temp`` maps an address to the mask of lanes that redirected a
  store to temporary storage.  Each op resolves its skip masks once for
  the whole group; a full-mask consensus skips the op for every lane with
  no per-lane work at all, and only the surviving lanes run the per-lane
  probe/admission **microstep**.  When predicates disagree across lanes
  (mixed dummy bits, mixed hit/miss, mixed MSHR admission) the op
  microsteps *for that op only* — never scalar-from-here; the per-group
  microstep rate is reported through the sweep diagnostics into
  ``BENCH_sim.json``.

* **Lockstep stall windows.**  Lanes that stall at the same demand access
  walk the shared window positions together.  Each lane's reach is its
  own quantized ``ceil((deadline - now) / ii)`` bound, so lanes drop out
  of the walk at their own precomputed position (the walk proceeds in
  segments between drop boundaries; the active cohort is constant inside
  a segment).  MSHR admissibility is prechecked per (lane, cache) at the
  window open — a window whose ``entries``-th outstanding fill only
  retires at/after the deadline can never admit a prefetch, which turns
  the entirety of an ``mshr=1`` lane's candidates into one-dict-get
  microsteps — and the walker clock is resolved lazily (a resident line
  whose fill completed before the window opened can never be in flight
  at ``now + k*ii``).

Single-lane groups run the scalar walker (:func:`_run_lane` /
:func:`_walk_window`) over the same shared columns; the scalar walker
has the per-cache admissibility precheck and the lazy clock on the
multi-cache path too, which is what the fig-17 reconfigured-geometry
lanes run.  The
scalar path doubles as the recording walker for the invariant tests.
Everything is pinned **bit-identical** to the scalar golden engine
(:func:`repro_torch.core.cgra._engine.run`): `tests/test_sweep.py` pins
full-``Stats`` parity over the widened Table-3 grid x paper kernels and
`tests/test_runahead_engine.py` pins the lockstep primitives (flat-set
LRU step, admission mask, reach quantization) against the oracle cache
and the golden walker op-for-op.
"""
from __future__ import annotations

from bisect import bisect_left as _bisect_left, bisect_right as _bisect_right, \
    insort as _insort

import numpy as np

from . import _engine
from .trace import Trace


class _Columns:
    """Shared preprocessing of one (trace, L1-shape, SPM-size) lane group.

    Everything here is timing-independent and identical for every lane in
    the group, so an N-lane MSHR sweep pays the vectorized passes once.
    """

    def __init__(self, trace: Trace, cfg):
        self.trace = trace
        self.ii = trace.ii
        l1cfgs = cfg.l1_configs()
        self.n_caches = cfg.n_caches
        self.l1_line = [c.line for c in l1cfgs]
        self.l1_ways = [c.ways for c in l1cfgs]
        self.l1_nsets = [c.sets for c in l1cfgs]

        starts = trace.iter_starts()
        self.starts = starts.tolist()
        self.n_iters = len(starts) - 1
        self.base = np.cumsum(
            trace.arbitration_extra(cfg.spm_bytes, self.n_caches)
            + trace.ii).tolist()

        self.spm_accesses = int(np.count_nonzero(
            trace.spm_mask(cfg.spm_bytes)))

        # demand work list: non-SPM accesses, with per-iteration ranges for
        # the non-empty iterations only (bulk-advance over the rest)
        al = trace.active_lists(cfg.spm_bytes)
        self.a_j = al["a_j"]
        self.a_store = al["a_store"]
        self.it_rows = al["it_rows"]

        # walker work list: accesses the §3.2 walker cannot skip
        wl = trace.walker_lists(cfg.spm_bytes)
        self.rel = wl["rel"]
        self.w_j = self.rel
        self.w_dep = wl["w_dep"]
        self.w_store = wl["w_store"]
        self.w_spm = wl["w_spm"]
        self.w_addr = wl["w_addr"]
        self.w_ord = wl["w_ord"]
        self.rel_bounds = wl["rel_bounds"]

        # per-geometry flat-set/tag/line/cache columns, memoized on the
        # trace and shared by every lane and every task of this group
        gl = trace.geometry_lists(
            cfg.spm_bytes, self.n_caches,
            tuple((c.ways, c.line, c.way_bytes) for c in l1cfgs))
        self.a_c = gl["a_c"]
        self.a_fs = gl["a_fs"]
        self.a_tag = gl["a_tag"]
        self.a_line = gl["a_line"]
        self.w_c = gl["w_c"]
        self.w_fs = gl["w_fs"]
        self.w_tag = gl["w_tag"]
        self.w_line = gl["w_line"]
        # per-flat-set way capacity (victim handling needs it without the
        # cache indirection)
        self.fs_ways = [w for c, w in enumerate(self.l1_ways)
                        for _ in range(self.l1_nsets[c])]


class _LaneState:
    """Complete per-lane machine state (content + timing).

    ``sets`` is the flat per-set L1: one dict per flat set index, insertion
    order == LRU order, entry == ``[fill, pf_unused, pf_id]`` — the golden
    engine's layout, addressed through the group's flat-set columns.
    """

    __slots__ = ("entries", "bus_latency", "bus_last", "l2_on", "l2_line",
                 "l2_nsets", "l2_ways", "l2_hit_lat", "l2_occ", "l1_occ",
                 "l2_sets", "sets", "mshr_ready", "dram", "l2_hits",
                 "prefetch_issued", "runahead_entries", "pf_records",
                 "pf_outcome")

    def __init__(self, g: _Columns, cfg):
        self.entries = cfg.mshr
        self.bus_latency = cfg.dram_latency
        self.bus_last = -10**18
        self.l2_on = cfg.l2 is not None
        bpc = max(1, cfg.dram_bus_bytes_per_cycle)
        if self.l2_on:
            self.l2_line = cfg.l2.line
            self.l2_nsets = cfg.l2.sets
            self.l2_ways = cfg.l2.ways
            self.l2_hit_lat = cfg.l2_hit_latency
            self.l2_occ = max(1, self.l2_line // bpc)
            self.l2_sets = [{} for _ in range(self.l2_nsets)]
            self.l1_occ = None
        else:
            self.l2_sets = None
            self.l1_occ = [max(1, ln // bpc) for ln in g.l1_line]
        self.sets = [{} for _ in range(len(g.fs_ways))]
        self.mshr_ready = [[] for _ in range(g.n_caches)]
        self.dram = 0
        self.l2_hits = 0
        self.prefetch_issued = 0
        self.runahead_entries = 0
        # pf_records: pf_id -> (cache, line, issue trace idx); outcome in
        # {"pending", "used", "evicted"} (see _engine._classify_prefetches)
        self.pf_records = []
        self.pf_outcome = []


def _admissible(lane: _LaneState, n_caches: int, now: int,
                deadline: int) -> list:
    """Per-cache MSHR admissibility over a window ``[now, deadline)``.

    Pruning against the window-open cycle is always safe (every later
    query is >= now), and lets admissibility be decided once per cache: if
    the ``entries``-th outstanding fill only retires at/after the deadline,
    no prefetch can be admitted anywhere in this window (the walker clock
    stays below the deadline, and the heap only grows).
    """
    entries = lane.entries
    adm = []
    for c in range(n_caches):
        rl = lane.mshr_ready[c]
        if rl:
            ip = _bisect_right(rl, now)
            if ip:
                del rl[:ip]
        adm.append(len(rl) < entries or rl[len(rl) - entries] < deadline)
    return adm


def _walk_window(g: _Columns, lane: _LaneState, j0: int, ord0: int, now: int,
                 deadline: int, blocked: int, ops: list | None = None) -> None:
    """True §3.2 walker for one stall window ``[now, deadline)``, scalar.

    Bit-identical to ``_engine.run``'s ``run_walker`` restructured onto the
    precomputed walker work list: the extent is resolved up front from the
    quantized reach, skippable accesses are never visited, admissibility
    is prechecked per cache, and the walker clock is lazy.  When ``ops``
    is a list the per-op content log is recorded (walker-invariant tests).
    """
    lane.runahead_entries += 1
    ii = g.ii
    c_stop = -((now - deadline) // ii)          # ceil((deadline - now) / ii)
    end_ord = ord0 + c_stop
    n_iters = g.n_iters
    if end_ord > n_iters:
        end_ord = n_iters
    i0 = _bisect_left(g.rel, j0)
    i1 = g.rel_bounds[end_ord]
    if i0 >= i1:
        return

    w_j = g.w_j
    w_dep = g.w_dep
    w_store = g.w_store
    w_spm = g.w_spm
    w_addr = g.w_addr
    w_ord = g.w_ord
    w_c = g.w_c
    w_fs = g.w_fs
    w_tag = g.w_tag
    w_line = g.w_line
    sets = lane.sets
    fs_ways = g.fs_ways
    l1_line = g.l1_line
    mshr_ready = lane.mshr_ready
    entries = lane.entries
    pf_records = lane.pf_records
    pf_outcome = lane.pf_outcome
    bus_latency = lane.bus_latency
    bus_last = lane.bus_last
    dram = lane.dram
    prefetch_issued = lane.prefetch_issued
    l2_on = lane.l2_on
    if l2_on:
        l2_line = lane.l2_line
        l2_nsets = lane.l2_nsets
        l2_ways = lane.l2_ways
        l2_hit_lat = lane.l2_hit_lat
        l2_occ = lane.l2_occ
        l2_sets = lane.l2_sets
        l2_hits = lane.l2_hits
    else:
        l1_occ = lane.l1_occ

    adm = _admissible(lane, g.n_caches, now, deadline)

    dummy = {blocked}
    temp = set()
    ra = now
    last_ord = ord0
    record = ops is not None
    for widx in range(i0, i1):
        dep = w_dep[widx]
        st = w_store[widx]
        if dep >= 0 and dep in dummy:
            if not st:
                dummy.add(w_j[widx])      # dummy address -> dummy value
            continue
        if w_spm[widx]:
            if st:
                temp.add(w_addr[widx])
            continue
        fs = w_fs[widx]
        d = sets[fs]
        tg = w_tag[widx]
        ent = d.get(tg)
        if not st:
            if w_addr[widx] in temp:
                continue
            if ent is not None:
                del d[tg]                 # probe touches resident lines
                d[tg] = ent
                if record:
                    o = w_ord[widx]
                    if o != last_ord:
                        ra = now + (o - ord0) * ii
                        last_ord = o
                    infl = ent[0] > ra
                    if infl:
                        dummy.add(w_j[widx])
                    ops.append((1, w_c[widx], fs, tg, o - ord0, infl))
                elif ent[0] > now:        # else: fill done before the window
                    o = w_ord[widx]
                    if o != last_ord:
                        ra = now + (o - ord0) * ii
                        last_ord = o
                    if ent[0] > ra:
                        dummy.add(w_j[widx])  # in-flight: value dummy
                continue
            dummy.add(w_j[widx])
        else:
            # redirect to temp storage + convert to prefetch-read (§3.2)
            temp.add(w_addr[widx])
            if ent is not None:
                del d[tg]
                d[tg] = ent
                if record:
                    ops.append((0, w_c[widx], fs, tg))
                continue
        # prefetch candidate (missing line): bounded by free MSHR entries
        c = w_c[widx]
        if not adm[c]:
            if record:
                ops.append((2, c, fs, tg, w_line[widx], w_j[widx],
                            w_ord[widx] - ord0, False))
            continue
        o = w_ord[widx]
        if o != last_ord:
            ra = now + (o - ord0) * ii
            last_ord = o
        rl = mshr_ready[c]
        if rl:
            ip = _bisect_right(rl, ra)
            if ip:
                del rl[:ip]
        ln = w_line[widx]
        if len(rl) < entries:
            free = True
            if l2_on:
                l2l = (ln * l1_line[c]) // l2_line
                d2 = l2_sets[l2l % l2_nsets]
                tg2 = l2l // l2_nsets
                r2 = d2.get(tg2)
                if r2 is not None and r2 <= ra:
                    del d2[tg2]           # touch: move to MRU
                    d2[tg2] = r2
                    l2_hits += 1
                    fill = ra + l2_hit_lat
                else:
                    dram += 1
                    fill = ra + bus_latency
                    if fill < bus_last + l2_occ:
                        fill = bus_last + l2_occ
                    bus_last = fill
                    if r2 is not None:    # refresh the in-flight line (MRU)
                        del d2[tg2]
                    elif len(d2) >= l2_ways:
                        del d2[next(iter(d2))]
                    d2[tg2] = fill
            else:
                dram += 1
                fill = ra + bus_latency
                if fill < bus_last + l1_occ[c]:
                    fill = bus_last + l1_occ[c]
                bus_last = fill
            if rl and fill < rl[-1]:
                _insort(rl, fill)
            else:
                rl.append(fill)
            pf_id = len(pf_records)
            pf_records.append((c, ln, w_j[widx]))
            pf_outcome.append("pending")
            ways = fs_ways[fs]
            if ways > 0:
                if len(d) >= ways:
                    victim = d.pop(next(iter(d)))
                    if victim[1] and victim[2] >= 0:
                        pf_outcome[victim[2]] = "evicted"
                d[tg] = [fill, True, pf_id]
            prefetch_issued += 1
        else:
            free = False
        if record:
            ops.append((2, c, fs, tg, ln, w_j[widx], o - ord0, free))

    lane.bus_last = bus_last
    lane.dram = dram
    lane.prefetch_issued = prefetch_issued
    if l2_on:
        lane.l2_hits = l2_hits


def _walk_window_1(g: _Columns, lane: _LaneState, j0: int, ord0: int,
                   now: int, deadline: int, blocked: int,
                   ops: list | None = None) -> None:
    """Single-cache specialization of :func:`_walk_window`.

    Every per-cache subscript is hoisted (for ``n_caches == 1`` the flat
    set index *is* the set index), the walker clock is resolved lazily,
    and the single admissibility bool gates the whole candidate path.
    Behavior is bit-identical to the general walker; the parity grid runs
    both.
    """
    lane.runahead_entries += 1
    ii = g.ii
    c_stop = -((now - deadline) // ii)
    end_ord = ord0 + c_stop
    n_iters = g.n_iters
    if end_ord > n_iters:
        end_ord = n_iters
    i0 = _bisect_left(g.rel, j0)
    i1 = g.rel_bounds[end_ord]
    if i0 >= i1:
        return

    rl = lane.mshr_ready[0]
    entries = lane.entries
    # pruning against the window-open cycle is always safe (every later
    # query is >= now), and lets admissibility be decided once: if the
    # (entries)-th outstanding fill only retires at/after the deadline, no
    # prefetch can be admitted anywhere in this window
    if rl:
        ip = _bisect_right(rl, now)
        if ip:
            del rl[:ip]
    admissible = len(rl) < entries or rl[len(rl) - entries] < deadline
    _walk_range_1(g, lane, i0, i1, now, ord0, now, ord0, admissible,
                  {blocked}, set(), ops)


def _walk_range_1(g: _Columns, lane: _LaneState, i0: int, i1: int, now: int,
                  ord0: int, ra: int, last_ord: int, admissible: bool,
                  dummy: set, temp: set, ops: list | None = None) -> None:
    """Walk positions ``[i0, i1)`` of a single-cache window scalar-style.

    The loop body of the §3.2 walker over explicit state, so it serves
    both :func:`_walk_window_1` (a whole window from its opening state)
    and the lockstep stepper's solo tail — once a shared window's active
    cohort drops to one lane there are no masks left to share, and the
    remaining positions run here with the surviving lane's dummy/temp
    sets and walker clock carried over.
    """
    ii = g.ii
    w_j = g.w_j
    w_dep = g.w_dep
    w_store = g.w_store
    w_spm = g.w_spm
    w_addr = g.w_addr
    w_ord = g.w_ord
    w_fs = g.w_fs
    w_tag = g.w_tag
    w_line = g.w_line
    sets = lane.sets
    ways0 = g.l1_ways[0]
    line0 = g.l1_line[0]
    rl = lane.mshr_ready[0]
    entries = lane.entries
    pf_records = lane.pf_records
    pf_outcome = lane.pf_outcome
    bus_latency = lane.bus_latency
    bus_last = lane.bus_last
    dram = lane.dram
    prefetch_issued = lane.prefetch_issued
    l2_on = lane.l2_on
    if l2_on:
        l2_line = lane.l2_line
        l2_nsets = lane.l2_nsets
        l2_ways = lane.l2_ways
        l2_hit_lat = lane.l2_hit_lat
        l2_occ = lane.l2_occ
        l2_sets = lane.l2_sets
        l2_hits = lane.l2_hits
    else:
        occ0 = lane.l1_occ[0]

    record = ops is not None
    for widx in range(i0, i1):
        dep = w_dep[widx]
        if dep >= 0 and dep in dummy:
            if not w_store[widx]:
                dummy.add(w_j[widx])      # dummy address -> dummy value
            continue
        if w_spm[widx]:
            if w_store[widx]:
                temp.add(w_addr[widx])
            continue
        fs = w_fs[widx]
        d = sets[fs]
        tg = w_tag[widx]
        ent = d.get(tg)
        if not w_store[widx]:
            if w_addr[widx] in temp:
                continue
            if ent is not None:
                del d[tg]                 # probe touches resident lines
                d[tg] = ent
                if record:
                    o = w_ord[widx]
                    if o != last_ord:
                        ra = now + (o - ord0) * ii
                        last_ord = o
                    infl = ent[0] > ra
                    if infl:
                        dummy.add(w_j[widx])
                    ops.append((1, 0, fs, tg, o - ord0, infl))
                elif ent[0] > now:        # else: fill done before the window
                    o = w_ord[widx]
                    if o != last_ord:
                        ra = now + (o - ord0) * ii
                        last_ord = o
                    if ent[0] > ra:
                        dummy.add(w_j[widx])
                continue
            dummy.add(w_j[widx])
        else:
            # redirect to temp storage + convert to prefetch-read (§3.2)
            temp.add(w_addr[widx])
            if ent is not None:
                del d[tg]
                d[tg] = ent
                if record:
                    ops.append((0, 0, fs, tg))
                continue
        # prefetch candidate (missing line): bounded by free MSHR entries
        if not admissible:
            if record:
                ops.append((2, 0, fs, tg, w_line[widx], w_j[widx],
                            w_ord[widx] - ord0, False))
            continue
        o = w_ord[widx]
        if o != last_ord:
            ra = now + (o - ord0) * ii
            last_ord = o
        if rl:
            ip = _bisect_right(rl, ra)
            if ip:
                del rl[:ip]
        ln = w_line[widx]
        if len(rl) < entries:
            free = True
            if l2_on:
                l2l = (ln * line0) // l2_line
                d2 = l2_sets[l2l % l2_nsets]
                tg2 = l2l // l2_nsets
                r2 = d2.get(tg2)
                if r2 is not None and r2 <= ra:
                    del d2[tg2]           # touch: move to MRU
                    d2[tg2] = r2
                    l2_hits += 1
                    fill = ra + l2_hit_lat
                else:
                    dram += 1
                    fill = ra + bus_latency
                    if fill < bus_last + l2_occ:
                        fill = bus_last + l2_occ
                    bus_last = fill
                    if r2 is not None:    # refresh the in-flight line (MRU)
                        del d2[tg2]
                    elif len(d2) >= l2_ways:
                        del d2[next(iter(d2))]
                    d2[tg2] = fill
            else:
                dram += 1
                fill = ra + bus_latency
                if fill < bus_last + occ0:
                    fill = bus_last + occ0
                bus_last = fill
            if rl and fill < rl[-1]:
                _insort(rl, fill)
            else:
                rl.append(fill)
            pf_id = len(pf_records)
            pf_records.append((0, ln, w_j[widx]))
            pf_outcome.append("pending")
            if ways0 > 0:
                if len(d) >= ways0:
                    victim = d.pop(next(iter(d)))
                    if victim[1] and victim[2] >= 0:
                        pf_outcome[victim[2]] = "evicted"
                d[tg] = [fill, True, pf_id]
            prefetch_issued += 1
        else:
            free = False
        if record:
            ops.append((2, 0, fs, tg, ln, w_j[widx], o - ord0, free))

    lane.bus_last = bus_last
    lane.dram = dram
    lane.prefetch_issued = prefetch_issued
    if l2_on:
        lane.l2_hits = l2_hits


def _run_lane(g: _Columns, cfg, stats, record: list | None = None) -> dict:
    """Run one runahead lane over the shared columns, mutating ``stats``.

    ``record`` — list to fill with per-window op logs (tests).  Returns a
    diagnostics dict.
    """
    lane = _LaneState(g, cfg)
    n_iters = g.n_iters
    stats.compute_cycles = n_iters * g.ii

    a_j = g.a_j
    a_c = g.a_c
    a_fs = g.a_fs
    a_tag = g.a_tag
    a_line = g.a_line
    a_store = g.a_store
    starts = g.starts
    base = g.base
    sets = lane.sets
    fs_ways = g.fs_ways
    l1_line = g.l1_line
    mshr_ready = lane.mshr_ready
    entries = lane.entries
    pf_outcome = lane.pf_outcome
    bus_latency = lane.bus_latency
    l2_on = lane.l2_on
    if l2_on:
        l2_line = lane.l2_line
        l2_nsets = lane.l2_nsets
        l2_ways = lane.l2_ways
        l2_hit_lat = lane.l2_hit_lat
        l2_occ = lane.l2_occ
        l2_sets = lane.l2_sets
    else:
        l1_occ = lane.l1_occ

    walk = _walk_window_1 if g.n_caches == 1 else _walk_window
    S = 0
    stall = 0
    l1_hits = l1_misses = uncovered = covered = prefetch_used = 0

    for t, lo, hi in g.it_rows:
        bt = base[t]
        now = bt + S
        for idx in range(lo, hi):
            fs = a_fs[idx]
            d = sets[fs]
            tg = a_tag[idx]
            ent = d.get(tg)
            st = a_store[idx]
            if ent is not None:
                del d[tg]                 # touch: move to MRU
                d[tg] = ent
                if ent[1]:                # prefetched, first demand use
                    ent[1] = False
                    if ent[2] >= 0:
                        pf_outcome[ent[2]] = "used"
                    prefetch_used += 1
                    covered += 1
                l1_hits += 1
                if st or ent[0] <= now:
                    continue
                ready = ent[0]            # in-flight fill: partial wait
            else:
                l1_misses += 1
                c = a_c[idx]
                rl = mshr_ready[c]
                if rl:
                    ip = _bisect_right(rl, now)
                    if ip:
                        del rl[:ip]
                # stall here if MSHR exhausted
                issue = now if len(rl) < entries else rl[len(rl) - entries]
                ln = a_line[idx]
                if l2_on:
                    l2l = (ln * l1_line[c]) // l2_line
                    d2 = l2_sets[l2l % l2_nsets]
                    tg2 = l2l // l2_nsets
                    r2 = d2.get(tg2)
                    if r2 is not None and r2 <= issue:
                        del d2[tg2]
                        d2[tg2] = r2
                        lane.l2_hits += 1
                        fill = issue + l2_hit_lat
                    else:
                        lane.dram += 1
                        fill = issue + bus_latency
                        if fill < lane.bus_last + l2_occ:
                            fill = lane.bus_last + l2_occ
                        lane.bus_last = fill
                        if r2 is not None:
                            del d2[tg2]
                        elif len(d2) >= l2_ways:
                            del d2[next(iter(d2))]
                        d2[tg2] = fill
                else:
                    lane.dram += 1
                    fill = issue + bus_latency
                    if fill < lane.bus_last + l1_occ[c]:
                        fill = lane.bus_last + l1_occ[c]
                    lane.bus_last = fill
                if rl and fill < rl[-1]:
                    _insort(rl, fill)
                else:
                    rl.append(fill)
                ways = fs_ways[fs]
                if ways > 0:
                    if len(d) >= ways:
                        victim = d.pop(next(iter(d)))
                        if victim[1] and victim[2] >= 0:
                            pf_outcome[victim[2]] = "evicted"
                    d[tg] = [fill, False, -1]
                if st:
                    if issue <= now:      # store buffer absorbs the miss
                        continue
                    ready = issue
                else:
                    uncovered += 1
                    ready = fill
            if ready > now:
                j = a_j[idx]
                j0 = j + 1
                ord0 = t if j0 < starts[t + 1] else t + 1
                ops = None
                if record is not None:
                    ops = []
                    record.append((j, -((now - ready) // g.ii), ops))
                walk(g, lane, j0, ord0, now, ready, j, ops)
                stall += ready - now
                S = ready - bt
                now = ready

    stats.cycles = (base[n_iters - 1] + S) if n_iters else 0
    stats.stall_cycles = stall
    stats.spm_accesses = g.spm_accesses
    stats.l1_hits = l1_hits
    stats.l1_misses = l1_misses
    stats.l2_hits = lane.l2_hits
    stats.dram_accesses = lane.dram
    stats.prefetch_issued = lane.prefetch_issued
    stats.prefetch_used = prefetch_used
    stats.covered_misses = covered
    stats.uncovered_misses = uncovered
    stats.runahead_entries = lane.runahead_entries

    _engine._classify_prefetches(g.trace, cfg, lane.pf_records,
                                 lane.pf_outcome, stats)
    return {"mode": "scalar", "windows": lane.runahead_entries}


def _lockstep_window(g: _Columns, lanes, stalled, j0: int, ord0: int,
                     blocked: int, counters) -> None:
    """Walk one stall window for every stalled lane in lockstep.

    ``stalled`` is ``[(lane_index, now, deadline), ...]``.  Each lane's
    quantized reach bounds its own walk; lanes drop out of the walk at
    their own precomputed end position (segments between drop boundaries
    keep the active cohort constant).  Skip predicates (dummy bits over
    ``addr_dep``, temp-storage redirects) are lane bitmasks resolved once
    per op; probes and MSHR admission run as per-lane microsteps over the
    flat-set dicts.  ``counters`` accumulates the group's lockstep and
    microstep op counts.
    """
    ii = g.ii
    n_iters = g.n_iters
    rel_bounds = g.rel_bounds
    i0 = _bisect_left(g.rel, j0)

    # per-window lane slots (parallel lists indexed by cohort position k)
    lane_a: list = []
    i1_a: list = []
    now_a: list = []
    dl_a: list = []
    ra_a: list = []
    lord_a: list = []
    adm_a: list = []
    sets_a: list = []
    mshr_a: list = []
    ent_a: list = []
    n_caches = g.n_caches
    for li, now, deadline in stalled:
        lane = lanes[li]
        c_stop = -((now - deadline) // ii)
        end_ord = ord0 + c_stop
        if end_ord > n_iters:
            end_ord = n_iters
        i1 = rel_bounds[end_ord]
        if i1 <= i0:
            lane.runahead_entries += 1     # empty window, as in the scalar
            continue
        lane_a.append(lane)
        i1_a.append(i1)
        now_a.append(now)
        dl_a.append(deadline)
        sets_a.append(lane.sets)
        mshr_a.append(lane.mshr_ready)
        ent_a.append(lane.entries)
    K = len(lane_a)
    if K == 0:
        return
    counters[0] += 1                       # windows walked
    nc1 = n_caches == 1
    if K == 1:
        # solo window: no masks to share — run the scalar walker body
        walk = _walk_window_1 if nc1 else _walk_window
        walk(g, lane_a[0], j0, ord0, now_a[0], dl_a[0], blocked)
        return
    for k in range(K):
        lane_a[k].runahead_entries += 1
        ra_a.append(now_a[k])
        lord_a.append(ord0)
        adm_a.append(_admissible(lane_a[k], n_caches, now_a[k], dl_a[k]))
    counters[1] += 1                       # windows shared by >= 2 lanes

    w_j = g.w_j
    w_dep = g.w_dep
    w_store = g.w_store
    w_spm = g.w_spm
    w_addr = g.w_addr
    w_ord = g.w_ord
    w_c = g.w_c
    w_fs = g.w_fs
    w_tag = g.w_tag
    w_line = g.w_line
    fs_ways = g.fs_ways
    l1_line = g.l1_line

    dummy: dict = {blocked: (1 << K) - 1}
    temp: dict = {}
    dummy_get = dummy.get
    temp_get = temp.get

    ops_total = counters[2]
    ops_micro = counters[3]

    # walk in segments between lane end positions: the active cohort is
    # constant inside a segment
    bounds = sorted(set(i1_a))
    cur = i0
    for seg_end in bounds:
        act = [k for k in range(K) if i1_a[k] > cur]
        if not act:
            break
        if len(act) == 1 and nc1:
            # solo tail: no masks left to share — run the scalar range
            # walker with the surviving lane's dummy/temp bits and clock
            k = act[0]
            bit = 1 << k
            counters[2] = ops_total + (i1_a[k] - cur)
            counters[3] = ops_micro
            _walk_range_1(g, lane_a[k], cur, i1_a[k], now_a[k], ord0,
                          ra_a[k], lord_a[k], adm_a[k][0],
                          {j for j, bm in dummy.items() if bm & bit},
                          {a for a, bm in temp.items() if bm & bit})
            return
        act_bm = 0
        for k in act:
            act_bm |= 1 << k
        n_act = len(act)
        ops_total += seg_end - cur
        for widx in range(cur, seg_end):
            dep = w_dep[widx]
            st = w_store[widx]
            if dep >= 0:
                bm = dummy_get(dep)
                if bm:
                    bm &= act_bm
                    if bm:
                        if not st:
                            jj = w_j[widx]
                            dummy[jj] = dummy_get(jj, 0) | bm
                        go = act_bm & ~bm
                        if not go:
                            continue      # consensus dummy skip
                        ops_micro += 1     # mixed dummy bits
                    else:
                        go = act_bm
                else:
                    go = act_bm
            else:
                go = act_bm
            if w_spm[widx]:
                if st:
                    a = w_addr[widx]
                    temp[a] = temp_get(a, 0) | go
                continue
            if st:
                a = w_addr[widx]
                temp[a] = temp_get(a, 0) | go
            else:
                tm = temp_get(w_addr[widx])
                if tm:
                    tm &= go
                    if tm:
                        go &= ~tm
                        if not go:
                            continue      # consensus temp-storage skip
                        ops_micro += 1     # mixed temp redirects
            if go == act_bm:
                cohort = act
                n_coh = n_act
            else:
                cohort = [k for k in act if (go >> k) & 1]
                n_coh = len(cohort)
            fs = w_fs[widx]
            tg = w_tag[widx]
            c = w_c[widx]
            o = -1
            nh = 0
            dmiss = 0
            nadm = 0
            nrej = 0
            for k in cohort:
                d = sets_a[k][fs]
                ent = d.get(tg)
                if ent is not None:
                    nh += 1
                    del d[tg]             # probe touches resident lines
                    d[tg] = ent
                    if st:
                        continue
                    f = ent[0]
                    if f > now_a[k]:
                        if o < 0:
                            o = w_ord[widx]
                        if o != lord_a[k]:
                            ra_a[k] = now_a[k] + (o - ord0) * ii
                            lord_a[k] = o
                        if f > ra_a[k]:
                            dmiss |= 1 << k  # in-flight: value dummy
                    continue
                # missing line
                if not st:
                    dmiss |= 1 << k
                if not adm_a[k][c]:
                    nrej += 1
                    continue
                if o < 0:
                    o = w_ord[widx]
                if o != lord_a[k]:
                    ra_a[k] = now_a[k] + (o - ord0) * ii
                    lord_a[k] = o
                ra = ra_a[k]
                rl = mshr_a[k][c]
                if rl:
                    ip = _bisect_right(rl, ra)
                    if ip:
                        del rl[:ip]
                if len(rl) >= ent_a[k]:
                    nrej += 1
                    continue
                nadm += 1
                lane = lane_a[k]
                ln = w_line[widx]
                if lane.l2_on:
                    l2l = (ln * l1_line[c]) // lane.l2_line
                    d2 = lane.l2_sets[l2l % lane.l2_nsets]
                    tg2 = l2l // lane.l2_nsets
                    r2 = d2.get(tg2)
                    if r2 is not None and r2 <= ra:
                        del d2[tg2]       # touch: move to MRU
                        d2[tg2] = r2
                        lane.l2_hits += 1
                        fill = ra + lane.l2_hit_lat
                    else:
                        lane.dram += 1
                        fill = ra + lane.bus_latency
                        bl = lane.bus_last + lane.l2_occ
                        if fill < bl:
                            fill = bl
                        lane.bus_last = fill
                        if r2 is not None:
                            del d2[tg2]
                        elif len(d2) >= lane.l2_ways:
                            del d2[next(iter(d2))]
                        d2[tg2] = fill
                else:
                    lane.dram += 1
                    fill = ra + lane.bus_latency
                    bl = lane.bus_last + lane.l1_occ[c]
                    if fill < bl:
                        fill = bl
                    lane.bus_last = fill
                if rl and fill < rl[-1]:
                    _insort(rl, fill)
                else:
                    rl.append(fill)
                pf_outcome = lane.pf_outcome
                pf_id = len(pf_outcome)
                lane.pf_records.append((c, ln, w_j[widx]))
                pf_outcome.append("pending")
                ways = fs_ways[fs]
                if ways > 0:
                    if len(d) >= ways:
                        victim = d.pop(next(iter(d)))
                        if victim[1] and victim[2] >= 0:
                            pf_outcome[victim[2]] = "evicted"
                    d[tg] = [fill, True, pf_id]
                lane.prefetch_issued += 1
            if dmiss:
                jj = w_j[widx]
                dummy[jj] = dummy_get(jj, 0) | dmiss
            if (0 < nh < n_coh) or (nadm and nrej):
                ops_micro += 1             # mixed residency / admission
        cur = seg_end

    counters[2] = ops_total
    counters[3] = ops_micro


def _run_lockstep(g: _Columns, cfgs, stats_list) -> list:
    """Advance every lane of the group together over the demand work list.

    Each op reads the shared columns once; every lane then runs its own
    probe/miss microstep against its flat-set dicts.  Lanes that stall at
    the same access walk the runahead window together
    (:func:`_lockstep_window`).
    """
    L = len(cfgs)
    lanes = [_LaneState(g, cfg) for cfg in cfgs]
    n_iters = g.n_iters
    ii = g.ii
    for stats in stats_list:
        stats.compute_cycles = n_iters * ii

    a_j = g.a_j
    a_c = g.a_c
    a_fs = g.a_fs
    a_tag = g.a_tag
    a_line = g.a_line
    a_store = g.a_store
    starts = g.starts
    base = g.base
    fs_ways = g.fs_ways
    l1_line = g.l1_line

    sets_L = [ln.sets for ln in lanes]
    mshr_L = [ln.mshr_ready for ln in lanes]
    ent_L = [ln.entries for ln in lanes]
    pfout_L = [ln.pf_outcome for ln in lanes]
    S_L = [0] * L
    stall_L = [0] * L
    hits_L = [0] * L
    miss_L = [0] * L
    cov_L = [0] * L
    unc_L = [0] * L
    pfu_L = [0] * L
    rng = range(L)
    # group counters: [windows, shared_windows, lockstep_ops, microstep_ops]
    counters = [0, 0, 0, 0]

    for t, lo, hi in g.it_rows:
        bt = base[t]
        for idx in range(lo, hi):
            fs = a_fs[idx]
            tg = a_tag[idx]
            st = a_store[idx]
            stalled = None
            for k in rng:
                d = sets_L[k][fs]
                ent = d.get(tg)
                now = bt + S_L[k]
                if ent is not None:
                    del d[tg]             # touch: move to MRU
                    d[tg] = ent
                    if ent[1]:            # prefetched, first demand use
                        ent[1] = False
                        if ent[2] >= 0:
                            pfout_L[k][ent[2]] = "used"
                        pfu_L[k] += 1
                        cov_L[k] += 1
                    hits_L[k] += 1
                    if st or ent[0] <= now:
                        continue
                    ready = ent[0]        # in-flight fill: partial wait
                else:
                    miss_L[k] += 1
                    c = a_c[idx]
                    rl = mshr_L[k][c]
                    if rl:
                        ip = _bisect_right(rl, now)
                        if ip:
                            del rl[:ip]
                    # stall here if MSHR exhausted
                    issue = now if len(rl) < ent_L[k] \
                        else rl[len(rl) - ent_L[k]]
                    ln = a_line[idx]
                    lane = lanes[k]
                    if lane.l2_on:
                        l2l = (ln * l1_line[c]) // lane.l2_line
                        d2 = lane.l2_sets[l2l % lane.l2_nsets]
                        tg2 = l2l // lane.l2_nsets
                        r2 = d2.get(tg2)
                        if r2 is not None and r2 <= issue:
                            del d2[tg2]
                            d2[tg2] = r2
                            lane.l2_hits += 1
                            fill = issue + lane.l2_hit_lat
                        else:
                            lane.dram += 1
                            fill = issue + lane.bus_latency
                            bl = lane.bus_last + lane.l2_occ
                            if fill < bl:
                                fill = bl
                            lane.bus_last = fill
                            if r2 is not None:
                                del d2[tg2]
                            elif len(d2) >= lane.l2_ways:
                                del d2[next(iter(d2))]
                            d2[tg2] = fill
                    else:
                        lane.dram += 1
                        fill = issue + lane.bus_latency
                        bl = lane.bus_last + lane.l1_occ[c]
                        if fill < bl:
                            fill = bl
                        lane.bus_last = fill
                    if rl and fill < rl[-1]:
                        _insort(rl, fill)
                    else:
                        rl.append(fill)
                    ways = fs_ways[fs]
                    if ways > 0:
                        if len(d) >= ways:
                            victim = d.pop(next(iter(d)))
                            if victim[1] and victim[2] >= 0:
                                pfout_L[k][victim[2]] = "evicted"
                        d[tg] = [fill, False, -1]
                    if st:
                        if issue <= now:  # store buffer absorbs the miss
                            continue
                        ready = issue
                    else:
                        unc_L[k] += 1
                        ready = fill
                if ready > now:
                    if stalled is None:
                        stalled = []
                    stalled.append((k, now, ready))
            if stalled:
                j = a_j[idx]
                j0 = j + 1
                ord0 = t if j0 < starts[t + 1] else t + 1
                _lockstep_window(g, lanes, stalled, j0, ord0, j, counters)
                for k, now, ready in stalled:
                    stall_L[k] += ready - now
                    S_L[k] = ready - bt

    diags = []
    for k in rng:
        lane = lanes[k]
        stats = stats_list[k]
        stats.cycles = (base[n_iters - 1] + S_L[k]) if n_iters else 0
        stats.stall_cycles = stall_L[k]
        stats.spm_accesses = g.spm_accesses
        stats.l1_hits = hits_L[k]
        stats.l1_misses = miss_L[k]
        stats.l2_hits = lane.l2_hits
        stats.dram_accesses = lane.dram
        stats.prefetch_issued = lane.prefetch_issued
        stats.prefetch_used = pfu_L[k]
        stats.covered_misses = cov_L[k]
        stats.uncovered_misses = unc_L[k]
        stats.runahead_entries = lane.runahead_entries
        _engine._classify_prefetches(g.trace, cfgs[k], lane.pf_records,
                                     lane.pf_outcome, stats)
        diags.append({"mode": "lockstep", "windows": lane.runahead_entries})
    windows, shared, ops, micro = counters
    diags[0]["group"] = {
        "lanes": L,
        "windows": windows,
        "shared_windows": shared,
        "lockstep_ops": ops,
        "microstep_ops": micro,
        "microstep_rate": (micro / ops) if ops else 0.0,
    }
    return diags


def run_group(trace: Trace, cfgs, stats_list) -> list[dict]:
    """Simulate a group of runahead lanes sharing one L1 shape over
    ``trace``, mutating the matching ``stats_list`` entries.  Returns the
    per-lane diagnostics (the first lane of a lockstep group carries the
    group's lockstep/microstep counters under ``"group"``).
    """
    g = _Columns(trace, cfgs[0])
    if len(cfgs) == 1:
        return [_run_lane(g, cfgs[0], stats_list[0])]
    return _run_lockstep(g, cfgs, stats_list)
