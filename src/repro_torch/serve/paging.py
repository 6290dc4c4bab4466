"""Host-side physical page-pool accounting for the paged KV cache.

The device arrays (``k_pages``/``v_pages`` pools and the ``page_table``)
live in the serve cache dict; this module is the allocator that decides
*which* physical page backs which (sequence, logical page) — a free-list
over ``n_pages - 1`` usable pages (physical page 0 is the reserved null
page that idle page-table entries point at, so masked writes always have a
harmless destination).

Pages are recycled without copying: retiring a sequence just returns its
page ids to the free list — the stale bytes left in them sit behind the
position mask of the next owner's attention reads (softmax weight exactly
0.0), so no scrub pass is needed.

Accounting is exact and checkable: :meth:`PagePool.check` verifies that
free + owned partitions the pool with no duplicates after every
allocate/free/preempt cycle (the engine calls it every step; the serve
benchmark reports it as ``page_leaks``).
"""
from __future__ import annotations


class PoolExhausted(RuntimeError):
    """No free physical pages (the caller decides: preempt or backpressure)."""


class PagePool:
    def __init__(self, n_pages: int, page_size: int):
        assert n_pages >= 2, "need the null page plus at least one real page"
        assert page_size >= 1
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list: hottest (most recently freed) page is reused first
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self._owned: dict[object, list[int]] = {}

    # -- capacity ------------------------------------------------------------
    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - self.free_pages

    def utilization(self) -> float:
        return self.used_pages / max(1, self.usable_pages)

    def pages_for(self, n_tokens: int) -> int:
        """Physical pages needed to hold ``n_tokens``."""
        return -(-n_tokens // self.page_size)

    def fits(self, n_tokens: int) -> bool:
        """Whether a sequence of ``n_tokens`` could EVER fit (pool capacity,
        not current free space) — requests beyond this must fail rather
        than deadlock the preemption loop."""
        return self.pages_for(n_tokens) <= self.usable_pages

    # -- allocation ----------------------------------------------------------
    def owned(self, owner) -> list[int]:
        return list(self._owned.get(owner, ()))

    def ensure(self, owner, n_tokens: int) -> list[int]:
        """Grow ``owner``'s page run to cover ``n_tokens``; returns the
        newly granted page ids (in logical-page order).  All-or-nothing:
        raises :class:`PoolExhausted` without partial allocation."""
        have = self._owned.setdefault(owner, [])
        need = self.pages_for(n_tokens) - len(have)
        if need <= 0:
            return []
        if need > len(self._free):
            raise PoolExhausted(
                f"{owner!r} needs {need} pages, {len(self._free)} free")
        grant = [self._free.pop() for _ in range(need)]
        have.extend(grant)
        return grant

    def free(self, owner) -> int:
        """Return all of ``owner``'s pages to the free list (copy-free
        retirement); returns how many were freed."""
        pages = self._owned.pop(owner, [])
        # freed most-recent-first so the LIFO free list hands back the
        # same ids in allocation order on the next ensure()
        self._free.extend(reversed(pages))
        return len(pages)

    # -- invariants ----------------------------------------------------------
    def check(self) -> None:
        """Exact accounting: free + owned partitions pages 1..n-1."""
        seen = list(self._free)
        for pages in self._owned.values():
            seen.extend(pages)
        if len(seen) != self.usable_pages or len(set(seen)) != len(seen) \
                or 0 in seen or any(not 0 < p < self.n_pages for p in seen):
            raise AssertionError(
                f"page leak: free={len(self._free)} owned="
                f"{ {k: len(v) for k, v in self._owned.items()} } "
                f"of {self.usable_pages} usable")
