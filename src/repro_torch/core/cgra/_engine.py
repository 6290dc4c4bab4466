"""A copy of ``repro.core.cgra._engine`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).  The tests the text below
names are the reference's.

Cycle-level simulation engine: the stall/runahead walk over trace arrays.

This module is the hot path behind :func:`repro_torch.core.cgra.simulate`.  The
public `simulator` module owns configuration (:class:`SimConfig`), statistics
(:class:`Stats`) and orchestration; this module owns the machinery:

* :class:`_DramBus` / :class:`_Mshr` — timing primitives (shared with the
  batched engine's per-lane timing replay);
* :func:`run` — the per-iteration walk (demand path + runahead walker).

The walk consumes the trace's *precomputed* views (``Trace.as_lists()``,
``Trace.iter_starts()``, ``Trace.spm_mask()``, ``Trace.cache_index()``,
``Trace.arbitration_extra()``) plus per-config (line, set, tag) columns
derived with one vectorized pass, so per-access work is plain-``int`` list
indexing and dict lookups.  L1/L2 state is kept as per-set ``dict``s whose
*insertion order is the LRU order* (hit → delete + reinsert moves an entry
to MRU; the victim is ``next(iter(set_dict))``): recency stamps in the old
``Cache``-object walk were unique and monotone, so ordering by them is
exactly ordering by last touch, and the dict form needs no counter and no
``min()`` scan.  The cycle-by-cycle semantics are bit-identical to the
pre-split simulator; `tests/test_sweep.py` pins that with golden cycle
counts, and the batched engine (:mod:`._batch_engine`) is pinned against
this one.

This walk remains the golden reference for both lane-parallel engines:
``_batch_engine`` (demand lanes, shared content phase) and
``_runahead_engine`` (runahead lanes, columnar lane-lockstep advance over
shared trace columns) are each pinned bit-identical to it.
``REPRO_SWEEP_ENGINE=scalar`` forces sweeps down this path.
"""
from __future__ import annotations

import bisect

import numpy as np

from .trace import Trace


class _DramBus:
    """Fixed-latency DRAM whose return bus transfers ``bytes_per_cycle``:
    a request for a B-byte line occupies the bus for B/bytes_per_cycle
    cycles, so back-to-back large-line fills serialize (bandwidth cap)."""

    def __init__(self, latency: int, bytes_per_cycle: int):
        self.latency = latency
        self.bytes_per_cycle = max(1, bytes_per_cycle)
        self._last_return = -10**18

    def request(self, now: int, nbytes: int) -> int:
        occupancy = max(1, nbytes // self.bytes_per_cycle)
        ready = max(now + self.latency, self._last_return + occupancy)
        self._last_return = ready
        return ready


class _Mshr:
    """Outstanding-fill bookkeeping for one L1 (sorted ready times)."""

    def __init__(self, entries: int):
        self.entries = entries
        self.ready: list[int] = []

    def _prune(self, now: int) -> None:
        i = bisect.bisect_right(self.ready, now)
        if i:
            del self.ready[:i]

    def free_at(self, now: int) -> int:
        """Earliest cycle >= now with a free entry."""
        self._prune(now)
        if len(self.ready) < self.entries:
            return now
        return self.ready[len(self.ready) - self.entries]

    def occupy(self, ready: int) -> None:
        bisect.insort(self.ready, ready)

    def has_free(self, now: int) -> bool:
        self._prune(now)
        return len(self.ready) < self.entries


def _l1_columns(trace: Trace, cfg):
    """Per-access (line, set, tag) columns under ``cfg``'s L1 geometry.

    One vectorized pass replaces three Python arithmetic ops per access per
    simulated config.  Returns plain lists (fastest to index in the walk).
    """
    l1cfgs = cfg.l1_configs()
    cache_idx = trace.cache_index(cfg.n_caches)
    if len({(c.line, c.sets) for c in l1cfgs}) == 1:
        line = trace.addr // l1cfgs[0].line
        nsets = l1cfgs[0].sets
    else:
        lines_c = np.asarray([c.line for c in l1cfgs], dtype=np.int64)
        sets_c = np.asarray([c.sets for c in l1cfgs], dtype=np.int64)
        line = trace.addr // lines_c[cache_idx]
        nsets = sets_c[cache_idx]
    return (line.tolist(), (line % nsets).tolist(), (line // nsets).tolist())


def run(trace: Trace, cfg, stats) -> None:
    """Walk one trace through one configuration, mutating ``stats``."""
    n = len(trace)
    pe, addr, is_store, addr_dep, iter_id = trace.as_lists()
    in_spm = trace.spm_mask(cfg.spm_bytes).tolist()
    ii = trace.ii
    starts = trace.iter_starts().tolist()
    n_iters = len(starts) - 1
    stats.compute_cycles = n_iters * ii

    if cfg.spm_only:
        _run_spm_only(cfg, stats, in_spm, is_store, starts, n_iters, ii)
        return

    n_caches = cfg.n_caches
    cache_of = trace.cache_index(n_caches).tolist()
    extra = trace.arbitration_extra(cfg.spm_bytes, n_caches).tolist()
    acc_line, acc_set, acc_tag = _l1_columns(trace, cfg)

    l1cfgs = cfg.l1_configs()
    l1_line = [c.line for c in l1cfgs]
    l1_ways = [c.ways for c in l1cfgs]
    # entry := [ready_cycle, pf_unused, pf_id]; dict order == LRU order
    l1_sets: list[list[dict]] = [[{} for _ in range(c.sets)] for c in l1cfgs]
    mshrs = [_Mshr(cfg.mshr) for _ in l1cfgs]
    bus = _DramBus(cfg.dram_latency, cfg.dram_bus_bytes_per_cycle)

    # counters (folded into stats at the end)
    l1_hits = l1_misses = l2_hits = dram = 0
    spm_accesses = stall = uncovered = 0
    prefetch_issued = prefetch_used = covered = runahead_entries = 0
    # prefetch records: pf_id -> (cache_id, line_addr, issue_trace_idx)
    pf_records: list[tuple[int, int, int]] = []
    pf_outcome: list[str] = []  # "used" | "evicted" | "pending"

    if cfg.l2 is not None:
        l2_line = cfg.l2.line
        l2_nsets = cfg.l2.sets
        l2_ways = cfg.l2.ways
        l2_hit_lat = cfg.l2_hit_latency
        l2_sets: list[dict] = [{} for _ in range(l2_nsets)]

        def fill_latency(c: int, line: int, now: int) -> int:
            """Cycle at which a fill for ``line`` (L1 ``c``) completes."""
            nonlocal l2_hits, dram
            l2l = (line * l1_line[c]) // l2_line
            d2 = l2_sets[l2l % l2_nsets]
            tg2 = l2l // l2_nsets
            r2 = d2.get(tg2)
            if r2 is not None and r2 <= now:
                del d2[tg2]               # touch: move to MRU
                d2[tg2] = r2
                l2_hits += 1
                return now + l2_hit_lat
            dram += 1
            ready = bus.request(now, l2_line)
            if r2 is not None:            # refresh the in-flight line (MRU)
                del d2[tg2]
            elif len(d2) >= l2_ways:
                del d2[next(iter(d2))]
            d2[tg2] = ready
            return ready
    else:

        def fill_latency(c: int, line: int, now: int) -> int:
            nonlocal dram
            dram += 1
            return bus.request(now, l1_line[c])

    def prefetch(c: int, j: int, now: int) -> None:
        """Issue a precise prefetch (if an MSHR entry is free)."""
        nonlocal prefetch_issued
        mshr = mshrs[c]
        if not mshr.has_free(now):
            return
        ready = fill_latency(c, acc_line[j], now)
        mshr.occupy(ready)
        pf_id = len(pf_records)
        pf_records.append((c, acc_line[j], j))
        pf_outcome.append("pending")
        ways = l1_ways[c]
        if ways > 0:
            d = l1_sets[c][acc_set[j]]
            if len(d) >= ways:
                victim = d.pop(next(iter(d)))
                if victim[1] and victim[2] >= 0:
                    pf_outcome[victim[2]] = "evicted"
            d[acc_tag[j]] = [ready, True, pf_id]
        prefetch_issued += 1

    def run_walker(j0: int, now: int, deadline: int, blocked: int) -> None:
        """Runahead execution during the stall window [now, deadline)."""
        nonlocal runahead_entries
        runahead_entries += 1
        dummy: set[int] = {blocked}
        temp: set[int] = set()            # addrs written to temporary storage
        ra_cycle = now
        it = iter_id[j0] if j0 < n else -1
        j = j0
        while j < n and ra_cycle < deadline:
            if iter_id[j] != it:
                ra_cycle += ii
                it = iter_id[j]
                if ra_cycle >= deadline:
                    break
            dep = addr_dep[j]
            if dep >= 0 and dep in dummy:
                if not is_store[j]:
                    dummy.add(j)          # dummy address -> dummy value
                j += 1
                continue
            if in_spm[j]:
                if is_store[j]:
                    temp.add(addr[j])
                j += 1
                continue
            c = cache_of[j]
            d = l1_sets[c][acc_set[j]]
            tg = acc_tag[j]
            ent = d.get(tg)
            if is_store[j]:
                # redirect to temp storage + convert to prefetch-read (§3.2)
                temp.add(addr[j])
                if ent is None:
                    prefetch(c, j, ra_cycle)
                else:
                    del d[tg]             # probe touches resident lines
                    d[tg] = ent
                j += 1
                continue
            # load
            if addr[j] in temp:
                j += 1
                continue
            if ent is None:
                prefetch(c, j, ra_cycle)
                dummy.add(j)
            else:
                del d[tg]
                d[tg] = ent
                if ent[0] > ra_cycle:
                    dummy.add(j)          # in-flight: value dummy

            j += 1

    runahead = cfg.runahead
    cycle = 0
    for t in range(n_iters):
        s, e = starts[t], starts[t + 1]
        cycle += ii + extra[t]
        for j in range(s, e):
            if in_spm[j]:
                spm_accesses += 1
                continue
            c = cache_of[j]
            d = l1_sets[c][acc_set[j]]
            tg = acc_tag[j]
            ent = d.get(tg)
            st = is_store[j]
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
                if st or ent[0] <= cycle:
                    continue
                ready = ent[0]            # in-flight fill: partial wait
            else:
                l1_misses += 1
                mshr = mshrs[c]
                issue = mshr.free_at(cycle)  # stall here if MSHR exhausted
                fill = fill_latency(c, acc_line[j], issue)
                mshr.occupy(fill)
                ways = l1_ways[c]
                if ways > 0:
                    if len(d) >= ways:
                        victim = d.pop(next(iter(d)))
                        if victim[1] and victim[2] >= 0:
                            pf_outcome[victim[2]] = "evicted"
                    d[tg] = [fill, False, -1]
                if st:
                    if issue <= cycle:    # store buffer absorbs the miss
                        continue
                    ready = issue
                else:
                    uncovered += 1
                    ready = fill
            if ready > cycle:
                if runahead:
                    run_walker(j + 1, cycle, ready, j)
                stall += ready - cycle
                cycle = ready
    stats.cycles = cycle
    stats.stall_cycles = stall
    stats.spm_accesses = spm_accesses
    stats.l1_hits = l1_hits
    stats.l1_misses = l1_misses
    stats.l2_hits = l2_hits
    stats.dram_accesses = dram
    stats.prefetch_issued = prefetch_issued
    stats.prefetch_used = prefetch_used
    stats.covered_misses = covered
    stats.uncovered_misses = uncovered
    stats.runahead_entries = runahead_entries

    _classify_prefetches(trace, cfg, pf_records, pf_outcome, stats)


def _run_spm_only(cfg, stats, in_spm, is_store, starts, n_iters, ii) -> None:
    """SPM-only baseline: every non-SPM access is a word-wide DRAM
    transaction (stores absorbed by the write buffer)."""
    latency = cfg.dram_latency
    occupancy = max(1, 4 // max(1, cfg.dram_bus_bytes_per_cycle))
    last_return = -10**18
    spm_accesses = dram = stall = 0
    cycle = 0
    for t in range(n_iters):
        s, e = starts[t], starts[t + 1]
        cycle += ii
        for j in range(s, e):
            if in_spm[j]:
                spm_accesses += 1
                continue
            dram += 1
            ready = cycle + latency
            if ready < last_return + occupancy:
                ready = last_return + occupancy
            last_return = ready
            if not is_store[j]:
                stall += ready - cycle
                cycle = ready
    stats.cycles = cycle
    stats.stall_cycles = stall
    stats.spm_accesses = spm_accesses
    stats.dram_accesses = dram


def _classify_prefetches(trace: Trace, cfg, pf_records, pf_outcome,
                         stats) -> None:
    """Fig. 15 classification: used / evicted (useful, lost) / useless.

    A prefetch was *needed* iff the same line is demanded by the same cache
    after the issuing trace index; ``Trace.last_line_use`` memoizes the
    line -> last-demand-index map per (n_caches, cache, line size), so a
    sweep of many configs over one trace builds each map once.
    """
    if not pf_records:
        return
    l1cfgs = cfg.l1_configs()
    last_use = {c: trace.last_line_use(cfg.n_caches, c, l1cfgs[c].line)
                for c in set(r[0] for r in pf_records)}
    for pf_id, (c, line, issue_idx) in enumerate(pf_records):
        outcome = pf_outcome[pf_id]
        if outcome == "used":
            continue
        needed = last_use[c].get(line, -1) > issue_idx
        if needed:
            # "evicted" lost the line before use; "pending" is resident at
            # end of kernel but the demand never came back for it in time
            stats.prefetch_evicted += 1
        else:
            stats.prefetch_useless += 1
