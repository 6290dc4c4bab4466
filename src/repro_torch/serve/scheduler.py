"""Continuous-batching scheduler: requests, slots, admission, preemption.

Pure host-side policy — no tensors.  The engine asks :meth:`Scheduler.next_action`
what to run each step and the scheduler answers from three pieces of state:
the FIFO wait queue, the slot table (which request occupies which batch
slot), and the page pool's free count.

Policy choices (deliberately simple, and tested):

* **FIFO admission** — requests are admitted in arrival order, never
  reordered, so no request can starve behind later arrivals (fairness is a
  test, not a hope).
* **Chunked prefill with alternation** — prefill runs one chunk at a time
  and strictly alternates with decode when both have work, so a long
  prompt cannot stall every live decode stream for its full length.
* **Preempt youngest first** — under page pressure the most recently
  admitted sequence is evicted (least sunk cost) and requeued at the
  FRONT of the queue, preserving FIFO completion order.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Callable, Optional

from .paging import PagePool


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"


TERMINAL = (RequestState.FINISHED, RequestState.CANCELLED, RequestState.FAILED)


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0      # 0.0 = greedy
    seed: int = 0                 # per-request; keys derive from (seed, token_index)
    max_new_tokens: int = 32
    stop_token: Optional[int] = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    params: SamplingParams
    arrival: float = 0.0
    deadline: Optional[float] = None          # absolute time; None = no timeout
    stream_cb: Optional[Callable[[int, "Request"], None]] = None

    state: RequestState = RequestState.QUEUED
    slot: int = -1
    cache_len: int = 0            # tokens currently written to this request's KV
    pending_token: Optional[int] = None  # sampled, not yet fed back as input
    out_tokens: list = dataclasses.field(default_factory=list)
    preemptions: int = 0
    error: str = ""
    metrics: Any = None

    @property
    def prefill_tokens(self) -> list[int]:
        """Tokens to (re)write during prefill: the prompt, plus — after a
        preemption — every generated token already fed back (all but the
        pending one, which resumes as the first decode input)."""
        if self.out_tokens:
            return self.prompt + self.out_tokens[:-1]
        return self.prompt

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.params.max_new_tokens

    def done_reason(self) -> str:
        if self.state is RequestState.FINISHED:
            last = self.out_tokens[-1] if self.out_tokens else None
            return ("stop" if last is not None
                    and last == self.params.stop_token else "length")
        return self.state.value


@dataclasses.dataclass
class Action:
    """What the engine should run this step."""
    kind: str                     # "prefill" | "decode" | "idle"
    request: Optional[Request] = None   # prefill target


class Scheduler:
    def __init__(self, *, slots: int, max_len: int, pool: PagePool,
                 prefill_chunk: int = 16, max_queue: int = 1024):
        self.n_slots = slots
        self.max_len = max_len
        self.pool = pool
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * slots
        self._last_kind = "decode"    # so the first mixed step prefers prefill
        self.n_preemptions = 0

    # -- bookkeeping ---------------------------------------------------------
    def live(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def occupancy(self) -> int:
        return sum(r is not None for r in self.slots)

    def has_work(self) -> bool:
        return bool(self.queue) or self.occupancy() > 0

    def _free_slot(self) -> int:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return -1

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue; raises/fails instead of accepting impossible work."""
        if len(self.queue) >= self.max_queue:
            from .engine import Backpressure
            raise Backpressure(
                f"queue full ({self.max_queue}); retry later")
        if req.total_len > self.max_len or not self.pool.fits(req.total_len):
            req.state = RequestState.FAILED
            req.error = (f"needs {req.total_len} tokens > capacity "
                         f"(max_len={self.max_len})")
            return
        self.queue.append(req)

    def admit(self) -> list[Request]:
        """Move queued requests into free slots, in FIFO order.

        A request is admitted only when a slot is free AND the pool can
        grant the pages for its first prefill chunk — admission never
        triggers preemption (only *growth* of already-running sequences
        does, see :meth:`ensure_pages`)."""
        admitted = []
        while self.queue:
            slot = self._free_slot()
            if slot < 0:
                break
            req = self.queue[0]
            first = min(self.prefill_chunk, len(req.prefill_tokens))
            if self.pool.pages_for(first) > self.pool.free_pages:
                break        # head-of-line blocks: FIFO, no bypass
            self.queue.popleft()
            try:
                self.pool.ensure(req.rid, first)
            except Exception:   # pragma: no cover - guarded above
                self.queue.appendleft(req)
                break
            req.slot = slot
            req.state = RequestState.PREFILL
            self.slots[slot] = req
            admitted.append(req)
        return admitted

    def release(self, req: Request, state: RequestState, error: str = "") -> int:
        """Retire a request: free its pages and slot.  Returns pages freed."""
        req.state = state
        if error:
            req.error = error
        if 0 <= req.slot < self.n_slots and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        req.slot = -1
        return self.pool.free(req.rid)

    def preempt_youngest(self, exclude: Optional[Request] = None) -> Optional[Request]:
        """Evict the most recently admitted live request; requeue at front.

        Returns the victim (engine must reset its cache length) or None if
        nothing is evictable."""
        victims = [r for r in self.live()
                   if r is not exclude and r.state not in TERMINAL]
        if not victims:
            return None
        victim = max(victims, key=lambda r: r.arrival)
        self.release(victim, RequestState.QUEUED)
        # restart prefill from scratch — pages were freed, KV is gone; the
        # sampled-but-unconsumed token is kept so the token stream resumes
        # exactly where it left off
        victim.cache_len = 0
        victim.preemptions += 1
        self.n_preemptions += 1
        self.queue.appendleft(victim)
        return victim

    def ensure_pages(self, req: Request, n_tokens: int) -> list[Request]:
        """Grow ``req`` to ``n_tokens``, preempting others if needed.

        Returns the list of victims (possibly empty).  ``req`` itself is
        never chosen as a victim; if the pool still can't satisfy the
        request after evicting everyone else, ``req`` is preempted too
        (back to the queue) rather than deadlocking."""
        from .paging import PoolExhausted
        victims = []
        while True:
            try:
                self.pool.ensure(req.rid, n_tokens)
                return victims
            except PoolExhausted:
                v = self.preempt_youngest(exclude=req)
                if v is None:
                    victims.append(self.preempt_youngest())  # req itself
                    return victims
                victims.append(v)

    # -- step selection ------------------------------------------------------
    def next_action(self) -> Action:
        """Pick the next step: alternate prefill/decode when both pending."""
        prefills = [r for r in self.live() if r.state is RequestState.PREFILL]
        decodes = [r for r in self.live() if r.state is RequestState.DECODE]
        if prefills and (not decodes or self._last_kind == "decode"):
            self._last_kind = "prefill"
            # FIFO among pending prefills
            return Action("prefill", min(prefills, key=lambda r: r.arrival))
        if decodes:
            self._last_kind = "decode"
            return Action("decode")
        if prefills:
            self._last_kind = "prefill"
            return Action("prefill", min(prefills, key=lambda r: r.arrival))
        return Action("idle")
