"""A copy of ``repro.core.cgra.sweep`` (its workers run NumPy and the
standard library only), kept line for line but where the port must
differ:

* the store is the port's own: its key digests the port's simulator and
  profiler sources (:data:`_SRC_FILES`, the cache-grid kernel's CUDA
  source among them), and it lives in ``artifacts/simcache_torch/`` or
  under ``REPRO_TORCH_SIMCACHE``, never the reference's
  ``artifacts/simcache/`` — the two digests always differ, so either
  package's :meth:`SimCache.prune_stale` would delete every record of
  the other's in a shared root;
* the fork guard watches CUDA, not JAX (:func:`_pool_for_sweep`), and
  :func:`ensure_pool` forks its workers at once, not at the first task;
* :func:`reconfigure_cached` profiles on the card unless the caller asks
  for the CPU.

Parallel, content-addressed sweep engine for the cycle-level simulator.

Every paper figure is a sweep of (kernel trace x :class:`SimConfig`) points.
This module turns that into a first-class operation:

* **Points are content-addressed.**  A point's key is the SHA-256 of its
  canonicalized trace spec + config JSON + a digest of the simulator source
  files, so editing `_engine.py`/`cache.py`/`trace.py` (or bumping the record
  schema) automatically invalidates every cached result — stale entries
  simply become unreachable and :meth:`SimCache.prune_stale` deletes them.
* **Results persist** in
  ``artifacts/simcache_torch/<key[:2]>/<key>.json`` with a
  human-readable ``index.json`` summarizing what is cached.
* **Uncached points are batched by trace**: configs swept over one trace are
  grouped into lane batches (one batch per L1 shape, one for all SPM-only
  baselines, one per L1 shape for runahead configs) and dispatched to
  :func:`repro_torch.core.cgra.simulate_batch`, which runs a whole batch
  in a single pass over the trace — non-runahead lanes through the batched
  engine, runahead lanes through the columnar lane-lockstep runahead
  engine (``REPRO_SWEEP_ENGINE=scalar`` forces everything down the golden
  one-task-per-point scalar path instead).
* **Tasks run in parallel** across worker processes (``concurrent.futures``,
  *fork* context — workers inherit the parent's imports copy-on-write and
  start instantly; see :func:`_pool_context`), with a per-process trace memo
  so the tasks of one kernel build its trace once per worker, not once per
  task.  Tasks are ordered trace-major (heaviest trace first, heaviest lane
  batch first within a trace) so the handful of traces in flight at any
  moment stays within the worker memo and no worker rebuilds a trace it
  just evicted.
* **Completion is crash-safe and elastic.**  Every computed point becomes
  durable the moment its task finishes — simcache record first, then a
  write-ahead journal entry (:mod:`.journal`, one atomic-rename append per
  point) — so a ``kill -9``'d sweep re-invoked over the same grid resumes
  from journal + simcache and produces bit-identical results, reporting
  how many points it resumed.  With leases enabled
  (``REPRO_SWEEP_LEASES=1`` or ``leases=...``), N independent ``sweep()``
  processes sharing one store root cooperatively drain one grid: every
  point is claimed through a digest-keyed TTL-heartbeat lease file
  (:mod:`repro_torch.runtime.leases`), unclaimed points are polled for peer
  results, and expired leases are reclaimed (work stealing) — the only
  source of duplicate simulation, and it is counted.

Trace specs are picklable descriptions, never `Trace` objects:

* ``"gcn_cora"`` — a name in :data:`repro_torch.core.cgra.trace.KERNELS`;
* ``("gcn_aggregate", {"dataset": "cora", "max_edges": 800})`` — a public
  factory in :mod:`repro_torch.core.cgra.trace` or
  :mod:`repro_torch.core.cgra.workloads` plus kwargs.

Typical use::

    from repro_torch.core.cgra import sweep
    results = sweep.sweep([(name, cfg) for name in kernels for cfg in cfgs])
    cycles = {r.point: r.stats.cycles for r in results}

§3.4 reconfiguration results are cached through the same store (kind
``"reconfig"``) via :func:`reconfigure_cached`; those run inline in the
calling process, with the profile on the card's cache-grid kernel — each
loop is fast enough that pool scheduling would cost more than it saves.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import pathlib
import shutil
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import torch

from repro_torch import resolve_device
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime import leases as leases_mod
from repro_torch.runtime import supervisor as supervisor_mod

from . import journal as journal_mod
from . import trace as trace_mod
from . import workloads as workloads_mod
from .cache import CacheConfig
from .simulator import SimConfig, Stats, simulate, simulate_batch
from .trace import Trace

# v2: records carry a content checksum, verified (and corrupt entries
# quarantined + recomputed) on every read
SCHEMA_VERSION = 2

#: source files whose content participates in every cache key; editing any of
#: them invalidates all previously stored results.  This module itself is
#: deliberately NOT digested: everything in it that affects stored content
#: flows into the key payload directly (spec/config canonicalization) or is
#: covered by SCHEMA_VERSION (record shape), so orchestration-only edits —
#: pool sizing, CLI — keep the store warm.  The profiler's sources stand
#: where the reference lists its ``jaxcache.py``.
_SRC_FILES = ("cache.py", "trace.py", "workloads.py", "simulator.py",
              "_engine.py", "_batch_engine.py", "_runahead_engine.py",
              "reconfig.py", "cache_grid.py", "csrc/cache_grid.cu")

DEFAULT_ROOT = (pathlib.Path(__file__).resolve().parents[4] / "artifacts"
                / "simcache_torch")

_digest_memo: str | None = None


def code_digest() -> str:
    """Digest of the simulator source tree (the invalidation token)."""
    global _digest_memo
    if _digest_memo is None:
        h = hashlib.sha256()
        here = pathlib.Path(__file__).resolve().parent
        for fname in _SRC_FILES:
            h.update(fname.encode())
            h.update((here / fname).read_bytes())
        _digest_memo = h.hexdigest()[:16]
    return _digest_memo


# ---------------------------------------------------------------------------
# Canonical JSON forms (trace specs + SimConfig)
# ---------------------------------------------------------------------------

TraceSpec = "str | tuple[str, dict]"


def normalize_spec(spec) -> dict:
    """Canonical JSON form of a trace spec (also validates it)."""
    if isinstance(spec, str):
        if spec not in trace_mod.KERNELS:
            raise KeyError(f"unknown kernel {spec!r}; see trace.KERNELS")
        return {"kernel": spec}
    if isinstance(spec, (tuple, list)) and len(spec) == 2:
        factory, kwargs = str(spec[0]), spec[1]
        if factory.startswith("_") or not callable(_factory(factory)):
            raise KeyError(f"unknown trace factory {factory!r}")
        return {"factory": factory, "kwargs": dict(kwargs)}
    raise TypeError(f"bad trace spec {spec!r}: want name or (factory, kwargs)")


def _factory(name: str):
    """Resolve a public trace factory: Table-1 generators live in
    :mod:`.trace`, the frontier/fuzz generators in :mod:`.workloads`."""
    return getattr(trace_mod, name, None) or getattr(workloads_mod, name, None)


def spec_label(spec_json: dict) -> str:
    if "kernel" in spec_json:
        return spec_json["kernel"]
    kw = ",".join(f"{k}={v}" for k, v in sorted(spec_json["kwargs"].items()))
    return f"{spec_json['factory']}({kw})"


def build_trace(spec_json: dict) -> Trace:
    if "kernel" in spec_json:
        return trace_mod.KERNELS[spec_json["kernel"]]()
    return _factory(spec_json["factory"])(**spec_json["kwargs"])


def _cache_cfg_to_json(c: CacheConfig | None):
    if c is None:
        return None
    return {"ways": c.ways, "line": c.line, "way_bytes": c.way_bytes}


def _cache_cfg_from_json(d) -> CacheConfig | None:
    return None if d is None else CacheConfig(**d)


def cfg_to_json(cfg: SimConfig) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(SimConfig)}
    d["l1"] = _cache_cfg_to_json(cfg.l1)
    d["l2"] = _cache_cfg_to_json(cfg.l2)
    d["l1_per_cache"] = (None if cfg.l1_per_cache is None else
                         [_cache_cfg_to_json(c) for c in cfg.l1_per_cache])
    return d


def cfg_from_json(d: dict) -> SimConfig:
    d = dict(d)
    d["l1"] = _cache_cfg_from_json(d["l1"])
    d["l2"] = _cache_cfg_from_json(d["l2"])
    if d["l1_per_cache"] is not None:
        d["l1_per_cache"] = tuple(_cache_cfg_from_json(c)
                                  for c in d["l1_per_cache"])
    return SimConfig(**d)


def point_key(spec_json: dict, cfg: SimConfig, kind: str = "sim",
              extra: dict | None = None) -> str:
    """Content key of one sweep point (includes the source digest)."""
    payload = {"schema": SCHEMA_VERSION, "digest": code_digest(),
               "kind": kind, "trace": spec_json, "cfg": cfg_to_json(cfg)}
    if extra:
        payload["extra"] = extra
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def trace_meta(tr: Trace) -> dict:
    return {"n_accesses": len(tr), "n_iters": tr.n_iters, "ii": tr.ii,
            "irregular_fraction": tr.irregular_fraction,
            "footprint": tr.footprint()}


# ---------------------------------------------------------------------------
# The keyed result store
# ---------------------------------------------------------------------------

#: record keys that must be present (per record kind) for a read to count;
#: a record missing them is corrupt — quarantined, never returned
_REQUIRED_KEYS = {
    "sim": ("trace", "cfg", "stats", "trace_meta"),
    "reconfig": ("trace", "cfg", "allocations", "lines", "profit", "config"),
}


def _record_checksum(record: dict) -> str:
    """Content checksum over the record minus its own ``checksum`` field."""
    body = {k: v for k, v in record.items() if k != "checksum"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class SimCache:
    """JSON-per-key result store under ``artifacts/simcache_torch/``.

    Layout: ``<root>/<key[:2]>/<key>.json`` plus an advisory ``index.json``
    (digest + one summary line per entry; rebuildable from the key files).
    Lookups never trust the index: :meth:`get` reads the key file and
    validates its schema/digest fields *and its content checksum* — a
    truncated, bit-rotted, or key-incomplete record is quarantined to
    ``<root>/quarantine/`` and reads as a miss, so the caller transparently
    recomputes it.  A missing or unreadable ``index.json`` is rebuilt from
    the shard files.
    """

    def __init__(self, root: str | os.PathLike | None = None):
        env = os.environ.get("REPRO_TORCH_SIMCACHE")
        self.root = pathlib.Path(root if root is not None else env or DEFAULT_ROOT)
        self._index: dict | None = None
        self.quarantined = 0        # corrupt records moved aside by this instance

    def path(self, key: str) -> pathlib.Path:
        return self.root / key[:2] / f"{key}.json"

    @staticmethod
    def _validate(text: str) -> tuple[dict | None, str | None]:
        """Parse + verify one record body -> (record, corruption_reason).

        ``(rec, None)`` — good; ``(None, None)`` — stale (old schema or
        source digest: a plain miss, prune's business, not corruption);
        ``(None, reason)`` — corrupt, quarantine it.
        """
        try:
            rec = json.loads(text)
        except ValueError as e:
            return None, f"unparseable JSON: {e}"
        if not isinstance(rec, dict):
            return None, f"not a JSON object ({type(rec).__name__})"
        if rec.get("schema") != SCHEMA_VERSION or rec.get("digest") != code_digest():
            return None, None
        if rec.get("checksum") != _record_checksum(rec):
            return None, "checksum mismatch (torn write / bit rot)"
        required = _REQUIRED_KEYS.get(rec.get("kind", "sim"), ("trace",))
        missing = [k for k in required if k not in rec]
        if missing:
            return None, f"missing record keys: {missing}"
        return rec, None

    def get(self, key: str) -> dict | None:
        if self.root.is_dir():
            self._load_index()      # memoized; heals a missing/corrupt index
        p = self.path(key)
        try:
            text = p.read_text()
        except OSError:
            return None
        rec, why = self._validate(text)
        if why is not None:
            self.quarantine(p, why)
            return None
        return rec

    def quarantine(self, path: pathlib.Path, reason: str) -> None:
        """Move a corrupt record aside (it stays inspectable, stops
        poisoning reads); the caller recomputes the point."""
        qdir = self.root / "quarantine"
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            os.replace(path, qdir / path.name)
        except OSError:
            try:
                path.unlink(missing_ok=True)
            except OSError:
                return          # unreadable AND unremovable: leave it to prune
        self.quarantined += 1

    def put(self, key: str, record: dict, *, flush_index: bool = True) -> None:
        record = {"schema": SCHEMA_VERSION, "digest": code_digest(), **record}
        record["checksum"] = _record_checksum(record)
        p = self.path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        _atomic_write(p, json.dumps(record, sort_keys=True))
        idx = self._load_index()
        idx["entries"][key] = self._index_entry(record)
        if flush_index:
            self.flush_index()

    @staticmethod
    def _index_entry(record: dict) -> dict:
        entry = {"kind": record.get("kind", "sim"),
                 "trace": spec_label(record["trace"])}
        if "stats" in record:
            entry["cycles"] = record["stats"].get("cycles")
        return entry

    def _load_index(self) -> dict:
        if self._index is None:
            rebuilt = False
            try:
                idx = json.loads((self.root / "index.json").read_text())
                assert isinstance(idx.get("entries"), dict)
            except (OSError, ValueError, AssertionError):
                # missing/corrupt index: rebuild the advisory summary from
                # the shard files themselves (the store's source of truth)
                idx = {"entries": self._scan_entries()}
                rebuilt = True
            idx["schema"] = SCHEMA_VERSION
            idx["digest"] = code_digest()
            self._index = idx
            if rebuilt and self.root.is_dir():
                self.flush_index()      # self-heal on disk right away
        return self._index

    def _scan_entries(self) -> dict:
        entries: dict[str, dict] = {}
        if not self.root.is_dir():
            return entries
        for p in sorted(self.root.glob("??/*.json")):
            try:
                rec, why = self._validate(p.read_text())
            except OSError:
                continue
            if rec is not None:
                entries[p.stem] = self._index_entry(rec)
        return entries

    def rebuild_index(self) -> int:
        """Rewrite ``index.json`` from the shard files; returns live entries."""
        self._index = {"schema": SCHEMA_VERSION, "digest": code_digest(),
                       "entries": self._scan_entries()}
        self.flush_index()
        return len(self._index["entries"])

    def flush_index(self) -> None:
        """Write the advisory index — safely under concurrent writers.

        Two processes flushing the same store used to race read-modify-
        write on ``index.json`` and silently drop each other's entries.
        The flush now (a) serializes against peers through a short-lived
        ``index.lock`` (O_EXCL; a crashed holder's stale lock is broken),
        and (b) **merges on flush**: the on-disk entries are re-read and
        unioned with this instance's view (ours win on conflict), so a
        peer's entries survive even when the lock degrades to best-effort.
        Entries whose shard files are gone are dropped either way (the
        index must never disagree with the store in the dangerous
        direction).
        """
        if self._index is None:
            return
        self.root.mkdir(parents=True, exist_ok=True)
        with _IndexLock(self.root):
            try:
                disk = json.loads((self.root / "index.json").read_text())
                disk_entries = disk.get("entries") \
                    if isinstance(disk, dict) else None
            except (OSError, ValueError):
                disk_entries = None
            entries = dict(self._index["entries"])
            if isinstance(disk_entries, dict):
                for k, v in disk_entries.items():
                    entries.setdefault(k, v)
            self._index["entries"] = {
                k: v for k, v in entries.items() if self.path(k).exists()}
            _atomic_write(self.root / "index.json",
                          json.dumps(self._index, sort_keys=True, indent=1))

    def prune_stale(self) -> int:
        """Delete entries written against a different source digest or schema
        (including pre-engine legacy files) plus stray ``.tmp`` droppings,
        every grid journal, and leftover lease files (stale resume/claim
        state goes with the results it described).  Unreadable/undeletable
        entries are skipped, never fatal.  Returns the number removed."""
        removed = 0
        if not self.root.is_dir():
            return 0
        journal_mod.SweepJournal.prune_all(self.root)
        shutil.rmtree(self.root / "leases", ignore_errors=True)
        for p in self.root.glob("??/*.json"):
            try:
                rec, why = self._validate(p.read_text())
                stale = rec is None          # old digest/schema OR corrupt
            except OSError:
                stale = True
            if stale:
                try:
                    p.unlink(missing_ok=True)
                    removed += 1
                except OSError:
                    continue                 # unreadable and stuck: skip
        for p in self.root.glob("??/*.tmp"):
            try:
                p.unlink(missing_ok=True)
            except OSError:
                continue
        self._load_index()
        self.flush_index()                   # drops entries without files
        return removed


def _atomic_write(path: pathlib.Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _IndexLock:
    """Advisory cross-process lock for the index read-merge-write.

    O_EXCL-created ``index.lock``; a lock older than ``stale`` seconds
    (its holder was killed) is broken.  If the lock cannot be won within
    ``timeout`` the flush proceeds unlocked — the merge-on-flush union
    still bounds the damage to losing a concurrent *same-instant* write,
    and the index is advisory (reads never trust it)."""

    def __init__(self, root: pathlib.Path, *, stale: float = 5.0,
                 timeout: float = 2.0):
        self.path = root / "index.lock"
        self.stale = stale
        self.timeout = timeout
        self._fd: int | None = None

    def __enter__(self):
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                self._fd = os.open(self.path,
                                   os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                return self
            except FileExistsError:
                try:
                    age = time.time() - self.path.stat().st_mtime
                except OSError:
                    age = 0.0
                if age > self.stale:
                    try:
                        self.path.unlink(missing_ok=True)
                    except OSError:
                        pass
                    continue
                if time.monotonic() > deadline:
                    return self          # degrade: merge without the lock
                time.sleep(0.005)
            except OSError:
                return self              # unwritable root: best effort

    def __exit__(self, *exc):
        if self._fd is not None:
            try:
                os.close(self._fd)
                self.path.unlink(missing_ok=True)
            except OSError:
                pass
            self._fd = None
        return False


# ---------------------------------------------------------------------------
# Parallel execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    point: "tuple"          # (label, SimConfig) as given
    key: str
    stats: Stats | None     # None only for quarantined points (error set)
    trace_meta: dict
    cached: bool            # True when served from the store
    engine: str = "scalar"  # "batched" | "runahead" | "scalar" | "failed"
    seconds: float = 0.0    # this point's share of its task's wall-clock
    cpu_seconds: float = 0.0  # this point's share of its task's CPU time
    diag: dict | None = None  # runahead-engine diagnostics (computed points
    #                           only; the first lane of a lockstep group
    #                           carries the group counters under "group")
    error: str | None = None  # quarantine reason (stats is None)


class SweepError(RuntimeError):
    """Some points were quarantined and the caller didn't allow partial
    results.  Carries the structured failure report and whatever results
    (cached + computed + failed placeholders) were assembled."""

    def __init__(self, failures: list[dict], results: list):
        self.failures = failures
        self.results = results
        labels = ", ".join(f["label"] for f in failures[:3])
        more = f" (+{len(failures) - 3} more)" if len(failures) > 3 else ""
        super().__init__(
            f"{len(failures)} sweep point(s) quarantined after retries and "
            f"scalar fallback: {labels}{more}")


#: the last sweep's SupervisorReport (None when everything was cached or no
#: sweep ran yet); callers read retry/quarantine counters from it
LAST_REPORT: "supervisor_mod.SupervisorReport | None" = None

#: the last sweep's elastic-service accounting: ``resumed`` (points served
#: from an interrupted run's journal + simcache), ``journal_torn`` (invalid
#: journal entries dropped on replay), ``peer_served`` (points another
#: worker computed while we waited on its lease), and ``lease`` (the
#: LeaseStats dict, or None when leases were off) — what the elastic
#: service's worker report carries
LAST_ELASTIC: dict = {}

#: sentinel: resolve the chaos plan from REPRO_CHAOS at call time
_ENV_CHAOS = object()


def _resolve_leases(leases, store: SimCache):
    """``leases`` argument -> LeaseManager | None (env-driven by default).

    ``None`` consults ``REPRO_SWEEP_LEASES`` (any non-empty value but "0"
    enables lease claiming over the store root, with
    ``REPRO_SWEEP_LEASE_TTL`` seconds TTL); ``True``/``False`` force it;
    a :class:`~repro_torch.runtime.leases.LeaseManager` is used as-is.
    """
    if isinstance(leases, leases_mod.LeaseManager):
        return leases
    if leases is None:
        env = os.environ.get("REPRO_SWEEP_LEASES", "")
        leases = bool(env) and env != "0"
    if not leases:
        return None
    ttl = float(os.environ.get("REPRO_SWEEP_LEASE_TTL",
                               leases_mod.DEFAULT_TTL))
    return leases_mod.LeaseManager(store.root, ttl=ttl)


#: per-process trace memo (worker processes are reused across map chunks and
#: across sweeps); bounded because a full-size trace plus its precomputed
#: list views can reach tens of MB
_worker_traces: dict[str, Trace] = {}
_WORKER_TRACE_CAP = 12


def _trace_for(spec_blob: str) -> Trace:
    tr = _worker_traces.get(spec_blob)
    if tr is None:
        while len(_worker_traces) >= _WORKER_TRACE_CAP:
            _worker_traces.pop(next(iter(_worker_traces)))
        tr = _worker_traces[spec_blob] = build_trace(json.loads(spec_blob))
    return tr


def prewarm_traces(points, store: SimCache | None = None) -> int:
    """Build traces (and their engine views) into the process-local memo.

    ``points`` are (trace-spec, SimConfig) pairs as given to :func:`sweep`.
    Call it *before* :func:`ensure_pool`: under the fork start
    method every worker inherits the parent's built traces — including the
    memoized demand/walker work lists the engines derive per SPM size —
    copy-on-write, so no worker rebuilds any of it mid-sweep.  Returns how
    many traces were built.  (Beyond-cap specs still build on demand in
    the workers; the memo keeps the most recent ``_WORKER_TRACE_CAP``.)

    With a ``store``, points already cached there are skipped, so a warm
    re-run builds nothing and goes straight to reading results back.
    """
    built: set[str] = set()
    for spec, cfg in points:
        spec_json = normalize_spec(spec)
        if store is not None and store.get(point_key(spec_json, cfg)) \
                is not None:
            continue
        blob = json.dumps(spec_json, sort_keys=True)
        if blob not in _worker_traces:
            built.add(blob)
        tr = _trace_for(blob)
        tr.as_lists()
        tr.iter_starts()
        tr.iter_index()
        tr.cache_index(cfg.n_caches)
        tr.arbitration_extra(cfg.spm_bytes, cfg.n_caches)
        tr.active_index(cfg.spm_bytes)
        if cfg.runahead and not cfg.spm_only:
            from . import _runahead_engine

            # building the column group warms every runahead-engine memo
            # (work lists + per-geometry line/set/tag columns)
            _runahead_engine._Columns(tr, cfg)
    return len(built)


def _force_scalar() -> bool:
    return os.environ.get("REPRO_SWEEP_ENGINE", "").lower() == "scalar"


def _lane_key(cfg: SimConfig, force_scalar: bool = False):
    """Task-grouping key: configs with equal keys become one batched task.

    ``None`` means "scalar fallback, one task per point" — only the forced
    golden-reference path (``REPRO_SWEEP_ENGINE=scalar``) uses it now.
    Runahead configs group per L1 shape just like demand configs: exactly
    the lanes the runahead engine can advance in columnar lockstep become
    one task, so a heavy trace's independent runahead groups (an MSHR
    sweep vs a reconfigured geometry) can run on different workers instead
    of serializing inside one oversized task.
    """
    if force_scalar:
        return None
    if cfg.spm_only:
        return ("spm",)
    if cfg.runahead:
        return ("ra", cfg.spm_bytes, cfg.n_caches,
                tuple((c.ways, c.line, c.way_bytes) for c in cfg.l1_configs()))
    return ("cache", cfg.spm_bytes, cfg.n_caches,
            tuple((c.ways, c.line, c.way_bytes) for c in cfg.l1_configs()))


def _run_batch(payload: dict, attempt: int = 0) \
        -> tuple[list, dict, list, float, float, list]:
    """Worker entry: one trace x a batch of SimConfig lanes.

    ``payload`` is built in :func:`sweep`: ``spec`` (trace-spec blob),
    ``cfgs`` (config blobs), ``scalar`` (route everything down the golden
    scalar engine — resolved once in the parent: pool workers are forked
    lazily and cached, so re-reading the environment here could disagree
    with the parent's routing decision), plus the supervision envelope
    (``key``/``site``/``chaos``/``ppid``) that lets a chaos plan fire
    deterministic faults inside the task body — the supervisor passes the
    ``attempt`` index so transient faults hit first attempts only.

    The returned wall-clock covers the whole task (trace build included) so
    the caller can attribute sweep time to engines;
    the CPU time alongside it separates engine compute from scheduler/SMT
    contention (on a contended box task wall can be ~2x task CPU); the
    trailing per-lane diagnostics carry the runahead engine's
    lockstep/microstep counters.
    """
    import time

    blob = payload.get("chaos")
    if blob:
        fault = chaos_mod.ChaosPlan.from_json(blob).fire(
            payload.get("site", "sweep.task"), payload["key"], attempt)
        if fault is not None:
            chaos_mod.apply_task_fault(
                fault, in_worker=os.getpid() != payload.get("ppid"))
    t0 = time.perf_counter()
    c0 = time.process_time()
    tr = _trace_for(payload["spec"])
    cfgs = [cfg_from_json(json.loads(b)) for b in payload["cfgs"]]
    diags: list = [None] * len(cfgs)
    if payload["scalar"]:
        stats = [simulate(tr, cfg) for cfg in cfgs]
        tags = ["scalar"] * len(cfgs)
    else:
        from . import _batch_engine

        stats = [Stats(name=tr.name) for _ in cfgs]
        tags = _batch_engine.run_batch(tr, cfgs, stats, diags)
    return ([s.to_dict() for s in stats], trace_meta(tr), tags,
            time.perf_counter() - t0, time.process_time() - c0, diags)


def _auto_workers() -> int:
    env = os.environ.get("REPRO_SWEEP_WORKERS")
    if env is not None:
        return int(env)
    return os.cpu_count() or 1


def _pool_context():
    """Worker-process start context (``REPRO_SWEEP_START`` overrides).

    ``fork`` is preferred: workers are ready instantly, share the parent's
    imports copy-on-write, and — unlike ``spawn``/``forkserver`` — never
    re-import torch or re-execute the caller's ``__main__``, which would
    cost seconds per worker.  Sweep workers themselves run only NumPy +
    pure Python and never touch CUDA, so fork is safe as long as the
    parent has not initialized CUDA yet; callers that mix the card and
    sweeps (``chip_smoke.py``) fork the pool with :func:`ensure_pool`
    before their first CUDA call.
    """
    method = os.environ.get("REPRO_SWEEP_START")
    if method is None:
        methods = multiprocessing.get_all_start_methods()
        method = "fork" if "fork" in methods else "spawn"
    return multiprocessing.get_context(method)


_executor: ProcessPoolExecutor | None = None
_executor_workers = 0


def ensure_pool(n_workers: int | None = None) -> ProcessPoolExecutor | None:
    """Create the shared worker pool now (idempotent).

    The pool is persistent: workers keep their trace memos warm across
    sweeps.  Under the fork start method the fork must happen before the
    process initializes CUDA, so callers that mix the card and sweeps
    (``chip_smoke.py``) call this once up front, before their first CUDA
    call; later sweeps reuse the already-forked workers safely.  A
    fork-context executor forks its workers at its first task, so one
    no-op task forks them here.
    """
    global _executor, _executor_workers
    if _executor is None:
        n = n_workers if n_workers is not None else _auto_workers()
        if n > 1:
            _executor = ProcessPoolExecutor(max_workers=n,
                                            mp_context=_pool_context())
            _executor_workers = n
            _executor.submit(os.getpid).result()
    return _executor


def _pool_for_sweep() -> ProcessPoolExecutor | None:
    """The shared pool, or ``None`` when parallelism must be declined.

    CUDA does not survive a fork: a child forked from a process that
    already initialized it inherits a context it cannot use, so if no
    pool exists yet and CUDA is initialized under the fork start method,
    run inline instead of forking now.  (``torch`` itself is always imported:
    the package imports it.)
    """
    if (_executor is None and torch.cuda.is_initialized()
            and _pool_context().get_start_method() == "fork"):
        return None
    return ensure_pool()


def shutdown_pool() -> None:
    """Tear down the shared worker pool (tests / embedders)."""
    global _executor, _executor_workers
    if _executor is not None:
        _executor.shutdown()
        _executor = None
        _executor_workers = 0


def _rebuild_pool() -> ProcessPoolExecutor | None:
    """Supervisor hook: replace the shared pool after a crash or hang kill.

    The broken executor is discarded without waiting (its workers are dead
    or killed); a fresh one is forked unless CUDA has been initialized
    since — then the supervisor degrades the rest of the run to inline
    execution
    (see :func:`_pool_for_sweep`).
    """
    global _executor, _executor_workers
    if _executor is not None:
        try:
            _executor.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        _executor = None
        _executor_workers = 0
    return _pool_for_sweep()


def _env_deadline() -> float | None:
    """Fixed per-task deadline from ``REPRO_SWEEP_DEADLINE`` (seconds), or
    None for the supervisor's adaptive robust-median deadline."""
    env = os.environ.get("REPRO_SWEEP_DEADLINE")
    return float(env) if env else None


def sweep(points, *, store: SimCache | None = None,
          workers: int | None = None, chaos=_ENV_CHAOS,
          allow_partial: bool = False, max_attempts: int | None = None,
          deadline: float | None = None, leases=None,
          lease_poll: float = 0.25, lease_wait: float = 600.0,
          on_point=None) -> list[SweepResult]:
    """Run every (trace-spec, SimConfig) point, supervised, through the store.

    Results come back in input order.  Cached points are served from
    ``artifacts/simcache_torch`` without building their traces; uncached points —
    runahead included — are grouped into per-trace lane batches (see
    :func:`_lane_key`) and run across ``workers`` processes (auto-detected
    by default; 0 or 1 forces inline execution, also via
    ``REPRO_SWEEP_WORKERS``).

    Execution is fault-tolerant (:class:`~repro_torch.runtime.supervisor.
    TaskSupervisor`): a worker crash rebuilds the pool and retries its
    tasks, a task past its deadline (``REPRO_SWEEP_DEADLINE`` or the
    adaptive robust-median bound) has its worker killed and is retried, a
    lane batch that exhausts its retries degrades to per-point tasks on
    the scalar golden engine, and a point that fails even there is
    *quarantined*: with ``allow_partial=True`` the sweep completes and the
    point's :class:`SweepResult` carries ``stats=None`` + ``error``;
    otherwise :class:`SweepError` is raised with the structured failure
    report.  The supervisor's counters land in :data:`LAST_REPORT` either
    way.  ``chaos`` accepts a :class:`~repro_torch.runtime.chaos.ChaosPlan`
    (default: resolved from ``REPRO_CHAOS``; pass None to force off) whose
    faults are injected deterministically into tasks and the store.

    Execution is also **crash-safe and elastic**:

    * every computed point becomes durable as its task completes — store
      record, then write-ahead journal entry — so killing this process at
      any moment loses at most the in-flight tasks; re-invoking the same
      grid resumes from journal + simcache (:data:`LAST_ELASTIC`
      ``resumed`` reports how many points were recovered that way);
    * with ``leases`` enabled (a :class:`~repro_torch.runtime.leases.
      LeaseManager`, ``True``, or ``REPRO_SWEEP_LEASES=1``), every point
      is claimed through a digest-keyed TTL lease before it is computed.
      Points a live peer holds are *deferred*: this process polls the
      store every ``lease_poll`` seconds for the peer's durable result,
      reclaims the lease once it expires (work stealing — the supervisor
      then rebalances the reclaimed points into fresh lane batches), and
      after ``lease_wait`` seconds without progress falls back to
      computing leaselessly (duplicates are idempotent to store).  The
      lease TTL is retuned each round from the supervisor watchdog's
      robust-median deadline.  ``on_point(key)`` fires after each point
      of this process becomes durable (the elastic service's lifecycle
      hook).
    """
    global LAST_REPORT, LAST_ELASTIC
    store = store if store is not None else SimCache()
    norm = []
    for spec, cfg in points:
        spec_json = normalize_spec(spec)
        norm.append((spec, cfg, spec_json, point_key(spec_json, cfg)))

    plan = chaos_mod.from_env() if chaos is _ENV_CHAOS else chaos

    # write-ahead journal for THIS grid: an interrupted run of the same
    # grid left validated completion entries behind, and a point that is
    # both journaled and durable in the store is a *resumed* point — a
    # crash-recovery, distinguishable from an ordinary warm-cache hit
    jrnl = journal_mod.SweepJournal(
        store.root, journal_mod.grid_key(k for *_, k in norm))
    journal_keys = jrnl.replay()

    results: dict[int, SweepResult] = {}
    todo: list[int] = []
    resumed = 0
    for i, (spec, cfg, spec_json, pkey) in enumerate(norm):
        rec = store.get(pkey)
        if rec is not None:
            results[i] = SweepResult((spec, cfg), pkey,
                                     Stats.from_dict(rec["stats"]),
                                     rec["trace_meta"], cached=True,
                                     engine=rec.get("engine", "scalar"))
            resumed += pkey in journal_keys
        else:
            todo.append(i)

    LAST_REPORT = None
    LAST_ELASTIC = {"resumed": resumed, "journal_torn": jrnl.torn,
                    "peer_served": 0, "lease": None}
    failures: list[dict] = []
    lm = _resolve_leases(leases, store)
    if lm is not None and lm.chaos is None:
        lm.chaos = plan

    if todo:
        chaos_blob = plan.to_json() if plan is not None else None
        parent_pid = os.getpid()
        force_scalar = _force_scalar()   # resolved once, shipped per task
        n_workers = min(workers if workers is not None else _auto_workers(),
                        len(todo))
        use_pool = n_workers > 1
        sup = supervisor_mod.TaskSupervisor(
            pool_factory=_pool_for_sweep if use_pool else None,
            pool_rebuild=_rebuild_pool if use_pool else None,
            max_attempts=(max_attempts if max_attempts is not None else
                          int(os.environ.get("REPRO_SWEEP_RETRIES", "3"))),
            deadline=deadline if deadline is not None else _env_deadline())
        agg = supervisor_mod.SupervisorReport()

        def _build_tasks(idx_list):
            """Group points into per-trace lane batches (runahead points
            group per L1 shape too; only the forced scalar path is
            one-per-task), trace-major heaviest first, each batch task
            degrading on retry exhaustion to per-point tasks on the
            scalar golden engine."""
            tasks: dict[tuple, list[int]] = {}
            trace_points: dict[str, int] = {}
            for i in idx_list:
                spec_blob = json.dumps(norm[i][2], sort_keys=True)
                lane = _lane_key(norm[i][1], force_scalar)
                tkey = (spec_blob, lane) if lane is not None \
                    else (spec_blob, None, i)
                tasks.setdefault(tkey, []).append(i)
                trace_points[spec_blob] = trace_points.get(spec_blob, 0) + 1

            def _task_order(kv):
                tkey, idxs = kv
                lane = tkey[1]
                is_ra = lane is not None and lane[0] == "ra"
                return (-trace_points[tkey[0]], tkey[0], not is_ra,
                        -len(idxs))

            owners: dict[str, list[int]] = {}
            sup_tasks: list[supervisor_mod.Task] = []
            for tkey, idxs in sorted(tasks.items(), key=_task_order):
                spec_blob = tkey[0]
                label = spec_label(json.loads(spec_blob))
                scalar_task = force_scalar or tkey[1] is None
                task_key = f"{label}|{tkey[1]}|{idxs[0]}"
                cfg_blobs = tuple(json.dumps(cfg_to_json(norm[i][1]),
                                             sort_keys=True) for i in idxs)

                def _payload(k, blobs, scalar):
                    return {"spec": spec_blob, "cfgs": blobs,
                            "scalar": scalar, "key": k, "chaos": chaos_blob,
                            "ppid": parent_pid,
                            "site": ("sweep.task.scalar" if scalar
                                     else "sweep.task.batch")}

                fallback = None
                if not scalar_task:
                    fb = []
                    for j, i in enumerate(idxs):
                        fkey = f"{task_key}!p{j}"
                        fb.append(supervisor_mod.Task(
                            fkey, _run_batch,
                            _payload(fkey, (cfg_blobs[j],), True)))
                        owners[fkey] = [i]
                    fallback = tuple(fb)
                owners[task_key] = idxs
                sup_tasks.append(supervisor_mod.Task(
                    task_key, _run_batch,
                    _payload(task_key, cfg_blobs, scalar_task), fallback))
            return sup_tasks, owners

        def _persist_for(owners):
            """The supervisor's on_result hook: make every point of a
            completed task durable *now* (record, then journal entry —
            the commit mark), release its lease, and notify the service
            hook.  A kill at any moment between points loses only the
            points not yet journaled."""
            def _persist(task, out):
                stats_ds, meta, tags = out[0], out[1], out[2]
                for i, stats_d, tag in zip(owners[task.key], stats_ds,
                                           tags):
                    spec, cfg, spec_json, pkey = norm[i]
                    store.put(pkey, {"kind": "sim", "trace": spec_json,
                                     "cfg": cfg_to_json(cfg),
                                     "stats": stats_d, "engine": tag,
                                     "trace_meta": meta},
                              flush_index=False)
                    if plan is not None:
                        fault = plan.fire("simcache.put", pkey, 0)
                        if fault is not None:
                            chaos_mod.corrupt_record(store, pkey, fault)
                    jrnl.append(pkey, {"engine": tag})
                    if plan is not None:
                        fault = plan.fire("journal.append", pkey, 0)
                        if fault is not None:
                            chaos_mod.corrupt_record(jrnl, pkey, fault)
                    if lm is not None:
                        lm.release(pkey)
                    if on_point is not None:
                        on_point(pkey)
                store.flush_index()     # merge-on-flush: peer-safe
            return _persist

        def _run_round(idx_list):
            sup_tasks, owners = _build_tasks(idx_list)
            rep = sup.run(sup_tasks, on_result=_persist_for(owners))
            agg.retries += rep.retries
            agg.crashes += rep.crashes
            agg.hangs += rep.hangs
            agg.pool_rebuilds += rep.pool_rebuilds
            agg.fallback_tasks += rep.fallback_tasks
            agg.results.update(rep.results)
            agg.failures.extend(rep.failures)
            for tkey2, out in rep.results.items():
                idxs = owners[tkey2]
                stats_ds, meta, tags, secs, cpu, diags = out
                share = secs / max(1, len(idxs))
                cpu_share = cpu / max(1, len(idxs))
                for i, stats_d, tag, diag in zip(idxs, stats_ds, tags,
                                                 diags):
                    spec, cfg, spec_json, pkey = norm[i]
                    results[i] = SweepResult((spec, cfg), pkey,
                                             Stats.from_dict(stats_d), meta,
                                             cached=False, engine=tag,
                                             seconds=share,
                                             cpu_seconds=cpu_share,
                                             diag=diag)
            # quarantined points: structured report + placeholder results
            for fail in rep.failures:
                for i in owners.get(fail.key, []):
                    if i in results:
                        continue
                    spec, cfg, spec_json, pkey = norm[i]
                    failures.append({"label": spec_label(spec_json),
                                     "key": pkey, "task": fail.key,
                                     "error": fail.error,
                                     "attempts": fail.attempts})
                    results[i] = SweepResult((spec, cfg), pkey, None, {},
                                             cached=False, engine="failed",
                                             error=fail.error)
                    if lm is not None:
                        lm.release(pkey)    # let a peer (or retry) try it
            for i in idx_list:               # defensive: no task covered it
                if i not in results:
                    spec, cfg, spec_json, pkey = norm[i]
                    failures.append({"label": spec_label(spec_json),
                                     "key": pkey, "task": "?",
                                     "error": "task lost", "attempts": 0})
                    results[i] = SweepResult((spec, cfg), pkey, None, {},
                                             cached=False, engine="failed",
                                             error="task lost")

        if lm is None:
            _run_round(todo)
        else:
            if use_pool:
                _pool_for_sweep()   # fork before the heartbeat thread starts
            lm.start_heartbeat()
            try:
                claimed = [i for i in todo if lm.acquire(norm[i][3])]
                claimed_set = set(claimed)
                deferred = [i for i in todo if i not in claimed_set]
                if claimed:
                    _run_round(claimed)
                waited = time.monotonic()
                while deferred:
                    lm.retune(sup.watchdog.deadline(floor=lm.ttl_floor))
                    ready, still = [], []
                    for i in deferred:
                        pkey = norm[i][3]
                        rec = store.get(pkey)
                        if rec is not None:   # a peer drained it, durably
                            spec, cfg, spec_json, _k = norm[i]
                            results[i] = SweepResult(
                                (spec, cfg), pkey,
                                Stats.from_dict(rec["stats"]),
                                rec["trace_meta"], cached=True,
                                engine=rec.get("engine", "scalar"))
                            LAST_ELASTIC["peer_served"] += 1
                        elif lm.acquire(pkey):
                            ready.append(i)   # free or expired: (re)claimed
                        else:
                            still.append(i)
                    deferred = still
                    if ready:
                        # the rebalance: reclaimed points regroup into
                        # fresh lane batches sized to what is left
                        _run_round(ready)
                        waited = time.monotonic()
                    elif deferred:
                        if time.monotonic() - waited > lease_wait:
                            # starvation guard: a peer heartbeats but never
                            # finishes; compute leaselessly (idempotent)
                            _run_round(deferred)
                            deferred = []
                        else:
                            time.sleep(lease_poll)
            finally:
                lm.stop()
            LAST_ELASTIC["lease"] = lm.stats.to_dict()
        LAST_REPORT = agg
        store.flush_index()
        if plan is not None:
            fault = plan.fire("simcache.index", "index", 0)
            if fault is not None:
                chaos_mod.corrupt_record(store, "index", fault)
        if lm is not None:
            # elastic barrier: fold every peer's shard files into the
            # index, so a worker killed between put and flush cannot cost
            # the store an index entry
            store.rebuild_index()
        if failures and not allow_partial:
            raise SweepError(failures,
                             [results[i] for i in range(len(norm))])
    if not failures:
        jrnl.complete()     # grid fully durable: retire its resume state
    return [results[i] for i in range(len(norm))]


def simulate_cached(spec, cfg: SimConfig,
                    store: SimCache | None = None) -> SweepResult:
    """One point, inline (store-backed); convenience over :func:`sweep`."""
    return sweep([(spec, cfg)], store=store, workers=0)[0]


# ---------------------------------------------------------------------------
# Cached §3.4 reconfiguration (runs inline; profiling is already fast)
# ---------------------------------------------------------------------------

def reconfigure_cached(spec, cfg: SimConfig, *, window: int | None = 16_384,
                       metric: str = "time",
                       store: SimCache | None = None, device=None):
    """Store-backed :func:`repro_torch.core.cgra.reconfig.reconfigure`,
    its profile on ``device`` (CUDA when None, which raises without a
    card even when the store holds the result).

    Returns a :class:`~repro_torch.core.cgra.reconfig.ReconfigResult` whose
    ``h_curves`` is ``None`` when served from the cache (the curves are
    profiling intermediates; allocations/lines/config are what callers use).
    The key leaves the device out: the card's profile is the CPU route's
    bit for bit, so a record does not depend on where it was computed.
    """
    device = resolve_device(device)
    store = store if store is not None else SimCache()
    spec_json = normalize_spec(spec)
    extra = {"window": window, "metric": metric}
    key = point_key(spec_json, cfg, kind="reconfig", extra=extra)
    from .reconfig import ReconfigResult, reconfigure

    rec = store.get(key)
    if rec is not None:
        return ReconfigResult(rec["allocations"], rec["lines"], rec["profit"],
                              None, cfg_from_json(rec["config"]))
    res = reconfigure(build_trace(spec_json), cfg, window=window, metric=metric,
                      device=device)
    store.put(key, {"kind": "reconfig", "trace": spec_json,
                    "cfg": cfg_to_json(cfg), "extra": extra,
                    "allocations": list(res.allocations),
                    "lines": list(res.lines), "profit": res.profit,
                    "config": cfg_to_json(res.config)})
    return res


def _main(argv=None) -> int:
    """``python -m repro_torch.core.cgra.sweep`` — inspect / prune the
    store."""
    import argparse

    ap = argparse.ArgumentParser(description="simcache store maintenance")
    ap.add_argument("--root", default=None, help="store root (default: "
                    "REPRO_TORCH_SIMCACHE or artifacts/simcache_torch)")
    ap.add_argument("--prune", action="store_true",
                    help="delete entries from older source digests/schemas")
    ap.add_argument("--rebuild-index", action="store_true",
                    help="rewrite index.json from the shard files")
    args = ap.parse_args(argv)
    store = SimCache(args.root)
    files = list(store.root.glob("??/*.json")) if store.root.is_dir() else []
    live = corrupt = 0
    for p in files:         # read-only census: _validate, never quarantine
        try:
            rec, why = store._validate(p.read_text())
        except OSError:
            rec, why = None, "unreadable"
        live += rec is not None
        corrupt += why is not None
    qdir = store.root / "quarantine"
    quarantined = sum(1 for _ in qdir.iterdir()) if qdir.is_dir() else 0
    print(f"root={store.root} entries={len(files)} current_digest={code_digest()}"
          f" live={live} stale={len(files) - live - corrupt}"
          f" corrupt={corrupt} quarantined={quarantined}")
    if args.prune:
        print(f"pruned={store.prune_stale()}")
    if args.rebuild_index:
        print(f"index_entries={store.rebuild_index()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
