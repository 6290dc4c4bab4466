"""The continuous-batching serving engine.

The port's twin of ``repro.serve.engine``.  Glues the host-side policy
(scheduler + page pool) to the fixed-shape steps from
:func:`repro_torch.launch.steps.build_serve_engine_steps`:

* every :meth:`ServeEngine.step` first cancels timed-out requests, admits
  from the queue into free slots, then runs ONE step — either a
  slot-batched decode step or one prefill chunk (strictly alternating when
  both have work);
* new requests join the batch the moment a slot frees mid-run (continuous
  batching) — the decode step's shapes never change, slots just flip their
  ``active`` bit;
* page-table / length state lives host-side in the scheduler and is
  *reconciled* onto the device cache before each call (tiny ``[slots]`` /
  ``[slots, pages]`` transfers) — no incremental device bookkeeping to
  drift;
* sampling keys derive from ``(request seed, token index)``, so a
  request's continuation is reproducible no matter how it is batched,
  preempted or re-queued.

Degradation paths are explicit: a full queue raises :class:`Backpressure`
at submit; pool pressure preempts the youngest sequence (re-queued, later
re-prefilled, token stream resumed exactly); per-request deadlines cancel
via the same retirement path as normal completion.

Fault drills plug into the chaos layer
(:mod:`repro_torch.runtime.chaos`): a plan — passed as ``chaos=`` or resolved
from ``REPRO_CHAOS`` — can reject admissions (``serve.backpressure``,
exercising client retry) and stretch recorded step times (``serve.step``,
exercising the straggler watchdog) deterministically from its seed.

Where the reference differs: the engine runs on the CUDA card unless the
caller passes ``device="cpu"`` (it raises when no card is present rather
than carry on on the CPU), and the paged backend reads decode attention
through the hand-written paged-attention kernel by default
(``attn_read="kernel"``; the reference defaults to ``"gather"``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device, sharding
from repro_torch.launch.steps import build_serve_engine_steps
from repro_torch.models import api
from repro_torch.models.paged_lm import serve_geometry
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime.elastic import reshard
from repro_torch.sharding.rules import MeshRules
from repro_torch.runtime.fault_tolerance import StragglerWatchdog

from .metrics import EngineMetrics, RequestMetrics
from .paging import PagePool
from .scheduler import (Request, RequestState, SamplingParams, Scheduler,
                        TERMINAL)


class Backpressure(RuntimeError):
    """Queue full: the client should back off and retry."""


def _key_data(seed: int, token_index: int) -> np.ndarray:
    """uint32[2] PRNG key material for one sampled token of one request."""
    return np.random.default_rng((seed, token_index)).integers(
        0, 2**32, size=2, dtype=np.uint32)


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 8, max_len: int = 256,
                 backend: str = "paged", page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 16,
                 attn_read: Optional[str] = None, max_queue: int = 1024,
                 detokenize: Optional[Callable[[int], object]] = None,
                 capture_logits: bool = False,
                 watchdog: Optional[StragglerWatchdog] = None,
                 chaos: Optional[chaos_mod.ChaosPlan] = None,
                 clock: Callable[[], float] = time.monotonic,
                 rules: Optional[MeshRules] = None,
                 device=None):
        """``params`` is the port's LM, already on ``device`` (CUDA when
        None).  ``attn_read`` defaults to ``"kernel"`` for the paged
        backend and ``"gather"`` for the dense one.  With ``rules`` the
        steps run on the rules' mesh: ``params`` is placed there by
        ``param_specs`` (in place: its parameters become DTensors) and the
        cache lives there, replicated."""
        self.device = resolve_device(device)
        ok, why = api.serve_supported(cfg)
        if not ok:
            raise ValueError(f"{cfg.name}: {why}")
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, the "
                             f"engine runs on {self.device}")
        if attn_read is None:
            attn_read = "kernel" if backend == "paged" else "gather"
        self.cfg = cfg
        self.backend = backend
        self.n_slots = slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.detokenize = detokenize
        self.capture_logits = capture_logits
        self.clock = clock

        self.pages_per_seq, _ = serve_geometry(max_len, page_size)
        if n_pages is None:
            n_pages = 1 + slots * self.pages_per_seq
        # the pool drives scheduling for BOTH backends (dense included), so
        # paged and dense runs make identical admission/preemption decisions
        self.pool = PagePool(n_pages, page_size)
        self.sched = Scheduler(slots=slots, max_len=max_len, pool=self.pool,
                               prefill_chunk=prefill_chunk,
                               max_queue=max_queue)
        if rules is not None:
            params = reshard(params, rules, rules.param_specs(params))
        self.params = params
        self.steps = build_serve_engine_steps(
            cfg, slots=slots, max_len=max_len, backend=backend,
            page_size=page_size, n_pages=n_pages, attn_read=attn_read,
            return_logits=capture_logits, rules=rules, device=self.device)
        self.cache = self.steps.init_cache()
        self.watchdog = watchdog if watchdog is not None else \
            StragglerWatchdog(window=32, threshold=3.0, min_samples=8)
        self.chaos = chaos if chaos is not None else chaos_mod.from_env()
        self.metrics = EngineMetrics()
        self.finished: list[Request] = []
        self._next_rid = 0

    # -- request intake ------------------------------------------------------
    def submit(self, prompt, *, temperature: float = 0.0, seed: int = 0,
               max_new_tokens: int = 32, stop_token: Optional[int] = None,
               timeout: Optional[float] = None,
               stream_cb=None, arrival: Optional[float] = None) -> Request:
        """Enqueue one request.  Raises :class:`Backpressure` when the
        queue is full; returns a FAILED request (never runnable) when the
        prompt + budget exceed cache capacity."""
        now = self.clock() if arrival is None else arrival
        req = Request(
            rid=self._next_rid,
            prompt=list(map(int, prompt)),
            params=SamplingParams(temperature=temperature, seed=seed,
                                  max_new_tokens=max_new_tokens,
                                  stop_token=stop_token),
            arrival=now,
            deadline=None if timeout is None else now + timeout,
            stream_cb=stream_cb,
            metrics=RequestMetrics(submit_time=now),
        )
        self._next_rid += 1
        if self.chaos is not None:
            fault = self.chaos.fire("serve.backpressure", str(req.rid))
            if fault is not None:
                raise Backpressure(
                    f"injected backpressure (chaos) for rid {req.rid}")
        if not req.prompt:
            req.state = RequestState.FAILED
            req.error = "empty prompt"
        else:
            self.sched.submit(req)          # may raise Backpressure
        if req.state is RequestState.FAILED:
            self.finished.append(req)
        else:
            # eager admission: grab a free slot now so queue capacity only
            # bounds genuinely *waiting* requests
            self.sched.admit()
            in_flight = len(self.sched.queue) + self.sched.occupancy()
            self.metrics.peak_in_flight = max(self.metrics.peak_in_flight,
                                              in_flight)
        return req

    # -- device-state reconciliation ----------------------------------------
    def _sync_cache(self) -> None:
        """Rebuild device lengths / page table from host truth."""
        lens = np.zeros((self.n_slots,), np.int32)
        for r in self.sched.live():
            lens[r.slot] = r.cache_len
        sharding.local(self.cache["lengths"]).copy_(torch.from_numpy(lens))
        if self.backend == "paged":
            table = np.zeros((self.n_slots, self.pages_per_seq), np.int32)
            for r in self.sched.live():
                owned = self.pool.owned(r.rid)
                table[r.slot, :len(owned)] = owned
            sharding.local(self.cache["page_table"]).copy_(
                torch.from_numpy(table))

    # -- lifecycle helpers ---------------------------------------------------
    def _retire(self, req: Request, state: RequestState, now: float,
                error: str = "") -> None:
        self.sched.release(req, state, error)
        req.metrics.finish_time = now
        self.finished.append(req)

    def _accept_token(self, req: Request, token: int, logits,
                      now: float) -> None:
        """A freshly sampled token becomes part of the request's stream."""
        req.out_tokens.append(token)
        req.pending_token = token
        req.metrics.on_token(now)
        self.metrics.tokens_sampled += 1
        if self.capture_logits:
            req.__dict__.setdefault("logits_log", []).append(
                logits.cpu().numpy())
        if req.stream_cb is not None:
            piece = self.detokenize(token) if self.detokenize else token
            req.stream_cb(piece, req)
        if (token == req.params.stop_token
                or len(req.out_tokens) >= req.params.max_new_tokens):
            self._retire(req, RequestState.FINISHED, now)

    def _scan_timeouts(self, now: float) -> None:
        for r in list(self.sched.queue):
            if r.deadline is not None and now >= r.deadline:
                self.sched.queue.remove(r)
                self._retire(r, RequestState.CANCELLED, now, "timeout")
                self.metrics.timeouts += 1
        for r in list(self.sched.live()):
            if r.deadline is not None and now >= r.deadline:
                self._retire(r, RequestState.CANCELLED, now, "timeout")
                self.metrics.timeouts += 1

    def cancel(self, req: Request, reason: str = "cancelled") -> None:
        if req.state in TERMINAL:
            return
        if req in self.sched.queue:
            self.sched.queue.remove(req)
        self._retire(req, RequestState.CANCELLED, self.clock(), reason)

    # -- the two step kinds --------------------------------------------------
    def _run_prefill(self, req: Request, now: float) -> None:
        toks = req.prefill_tokens
        n_valid = min(self.prefill_chunk, len(toks) - req.cache_len)
        self.sched.ensure_pages(req, req.cache_len + n_valid)
        if req.state is not RequestState.PREFILL:
            return                     # preempted itself under extreme pressure
        chunk = np.zeros((self.prefill_chunk,), np.int32)
        chunk[:n_valid] = toks[req.cache_len:req.cache_len + n_valid]
        req.metrics.on_admit(now)
        self._sync_cache()
        token, logits, self.cache = self.steps.prefill(
            self.params, chunk, np.int32(n_valid), np.int32(req.slot),
            np.float32(req.params.temperature),
            _key_data(req.params.seed, len(req.out_tokens)), self.cache)
        req.cache_len += n_valid
        if req.cache_len >= len(toks):             # final chunk
            req.state = RequestState.DECODE
            if req.out_tokens:
                # resumed after preemption: the re-prefill's sample is
                # discarded — the pre-preemption pending token carries on
                req.pending_token = req.out_tokens[-1]
            else:
                self._accept_token(req, int(token), logits, self.clock())

    def _run_decode(self, now: float) -> None:
        for r in list(self.sched.live()):
            if r.state is RequestState.DECODE:
                self.sched.ensure_pages(r, r.cache_len + 1)
        batch = [r for r in self.sched.live()
                 if r.state is RequestState.DECODE]
        if not batch:
            return
        tokens = np.zeros((self.n_slots,), np.int32)
        active = np.zeros((self.n_slots,), bool)
        temps = np.zeros((self.n_slots,), np.float32)
        key_data = np.zeros((self.n_slots, 2), np.uint32)
        for r in batch:
            tokens[r.slot] = r.pending_token
            active[r.slot] = True
            temps[r.slot] = r.params.temperature
            key_data[r.slot] = _key_data(r.params.seed, len(r.out_tokens))
        self._sync_cache()
        next_tokens, logits, self.cache = self.steps.decode(
            self.params, tokens, active, temps, key_data, self.cache)
        next_tokens = next_tokens.cpu().numpy()
        if logits is not None:
            logits = logits.cpu()
        done = self.clock()
        for r in batch:
            r.cache_len += 1
            self._accept_token(
                r, int(next_tokens[r.slot]),
                None if logits is None else logits[r.slot], done)

    # -- main loop -----------------------------------------------------------
    def step(self) -> bool:
        """Run one engine step; returns False when there was nothing to do."""
        now = self.clock()
        self._scan_timeouts(now)
        self.sched.admit()
        action = self.sched.next_action()
        if action.kind == "idle":
            return False
        t0 = time.monotonic()
        if action.kind == "prefill":
            self._run_prefill(action.request, now)
        else:
            self._run_decode(now)
        dt = time.monotonic() - t0
        if self.chaos is not None:
            fault = self.chaos.fire("serve.step", str(self.metrics.steps))
            if fault is not None and fault.kind == "delay":
                dt += fault.seconds       # stretch the measured step time
        if self.watchdog.record(self.metrics.steps, dt):
            self.metrics.stragglers += 1
        self.metrics.preemptions = self.sched.n_preemptions
        self.metrics.on_step(action.kind,
                             self.sched.occupancy() / self.n_slots,
                             self.pool.utilization())
        self.pool.check()
        return True

    def run(self, max_steps: Optional[int] = None) -> list[Request]:
        """Step until all submitted work is terminal; returns finished
        requests in completion order."""
        steps = 0
        while self.sched.has_work():
            if not self.step():
                break
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.finished

    # -- invariants ----------------------------------------------------------
    def assert_no_leaks(self) -> None:
        """After all requests are terminal: every page back on the free list."""
        self.pool.check()
        if self.sched.has_work():
            raise AssertionError("engine still has live work")
        if self.pool.used_pages != 0:
            raise AssertionError(
                f"page leak: {self.pool.used_pages} pages still owned")
