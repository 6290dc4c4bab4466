"""A copy of ``repro.core.cgra.cache`` (NumPy and the standard library
only), kept line for line so the port's results are the reference's
bit for bit (``tests/test_torch_cgra.py``).  The tests the text below
names are the reference's.

Set-associative cache models (reference semantics).

Two implementations with identical hit/miss semantics:

* :class:`Cache` — object-per-entry reference model with the full timing
  vocabulary (LRU, write-allocate, per-line fill ``ready`` time,
  prefetch-classification flags).  The engines themselves
  (:mod:`._engine`, :mod:`._batch_engine`) inline this behavior as per-set
  dicts whose insertion order is the LRU order; this class remains the
  readable specification they are pinned against.
* :class:`OracleCache` — a deliberately naive dict-of-lists reference used by
  the hypothesis property tests to pin down :class:`Cache`, the engines'
  LRU passes (``_batch_engine.lru_hit_series``) and the vectorized JAX
  model (``jaxcache.py``).

Addresses are byte addresses; a *line address* is ``addr // line``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Geometry of one cache.

    ``way_bytes`` is the size of a single way (the reallocation unit of the
    paper's cache-way reconfiguration, §3.4.1): a way holds
    ``way_bytes // line`` lines, so ``sets`` shrinks as the (virtual) line
    grows — exactly the paper's virtual-cache-line merge of 2^m physical
    lines within a way.
    """

    ways: int = 4
    line: int = 64           # bytes ("virtual" line size; physical merge 2^m)
    way_bytes: int = 1024    # bytes per way

    @property
    def sets(self) -> int:
        return max(1, self.way_bytes // self.line)

    @property
    def size(self) -> int:
        return self.ways * self.way_bytes

    def replace(self, **kw) -> "CacheConfig":
        return dataclasses.replace(self, **kw)


class _Entry:
    """One resident (or in-flight) cache line."""

    __slots__ = ("tag", "last_use", "dirty", "ready", "pf_unused", "pf_id")

    def __init__(self, tag: int, last_use: int, ready: int,
                 pf_unused: bool = False, pf_id: int = -1):
        self.tag = tag
        self.last_use = last_use
        self.dirty = False
        self.ready = ready          # cycle at which the fill completes
        self.pf_unused = pf_unused  # prefetched, not yet demanded (Fig. 15)
        self.pf_id = pf_id


class Cache:
    """LRU set-associative cache (reference timing-model flavour)."""

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        self.enabled = cfg.ways > 0
        self.sets: list[dict[int, _Entry]] = [dict() for _ in range(cfg.sets)]
        self._use = 0

    # -- geometry ----------------------------------------------------------
    def line_addr(self, addr: int) -> int:
        return addr // self.cfg.line

    def _set_tag(self, line_addr: int) -> tuple[int, int]:
        return line_addr % self.cfg.sets, line_addr // self.cfg.sets

    # -- operations ---------------------------------------------------------
    def probe(self, line_addr: int) -> _Entry | None:
        """Look up without touching LRU state."""
        if not self.enabled:
            return None
        s, tag = self._set_tag(line_addr)
        return self.sets[s].get(tag)

    def touch(self, entry: _Entry) -> None:
        self._use += 1
        entry.last_use = self._use

    def install(self, line_addr: int, ready: int, pf_unused: bool = False,
                pf_id: int = -1) -> _Entry | None:
        """Insert a line (demand fill or prefetch); returns the LRU victim
        entry (or None) so the caller can classify evicted prefetches."""
        if not self.enabled:
            return None
        s, tag = self._set_tag(line_addr)
        st = self.sets[s]
        victim = None
        if tag not in st and len(st) >= self.cfg.ways:
            vt = min(st, key=lambda t: st[t].last_use)
            victim = st.pop(vt)
        self._use += 1
        st[tag] = _Entry(tag, self._use, ready, pf_unused, pf_id)
        return victim


class OracleCache:
    """Reference LRU set-associative cache: returns a hit/miss bool per
    access.  No timing, no MSHR — semantic ground truth for tests."""

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        self.sets: list[list[int]] = [[] for _ in range(cfg.sets)]  # MRU last

    def access(self, addr: int) -> bool:
        if self.cfg.ways <= 0:
            return False
        line = addr // self.cfg.line
        s = line % self.cfg.sets
        tag = line // self.cfg.sets
        ls = self.sets[s]
        if tag in ls:
            ls.remove(tag)
            ls.append(tag)
            return True
        if len(ls) >= self.cfg.ways:
            ls.pop(0)
        ls.append(tag)
        return False

    def run(self, addrs) -> list[bool]:
        return [self.access(int(a)) for a in addrs]
