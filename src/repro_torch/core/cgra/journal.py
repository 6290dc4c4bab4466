"""A copy of ``repro.core.cgra.journal`` (the standard library only),
kept line for line so the port's journal entries are the reference's
(``tests/test_torch_journal.py``).

Durable write-ahead sweep journal: crash-safe progress for a point grid.

A sweep's unit of durability is the *point* — a pure, digest-keyed
computation whose result lands in the simcache.  The journal records, per
**grid** (the set of point keys one :func:`repro_torch.core.cgra.sweep.sweep`
call covers), which points have been computed *and made durable*, so a
``kill -9``'d sweep re-invoked over the same grid resumes from
journal + simcache instead of starting over, and can report exactly how
many points it resumed.

Layout and guarantees:

* One directory per grid under ``<simcache root>/journal/<grid key>/``.
  The grid key is a digest of the sorted point keys, and point keys
  already include the simulator source digest — so a source edit retires
  every old journal automatically (its grid can never be requested again).
* **Append = atomic rename.**  Each completed point is one entry file
  ``<point key>.json`` written via write-to-temp + ``os.replace``; there
  is no shared file to tear, and two cooperating worker processes can
  append to the same grid journal without coordination.
* Entries carry a content checksum.  :meth:`SweepJournal.replay` verifies
  it and silently drops (and deletes) torn or unparseable entries — a
  crash mid-append costs exactly that one entry, and the point simply
  recomputes (its ``torn`` count is reported).
* Entries are written *after* the point's simcache record is durable, so
  a replayed entry implies the result exists (the record is still
  re-validated on read; a corrupted record recomputes as usual and the
  journal entry is merely optimistic).
* :meth:`SweepJournal.complete` removes the grid directory once the whole
  grid finished cleanly — leftover directories are exactly the interrupted
  sweeps, which is what makes the resumed-point count meaningful.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import tempfile

SCHEMA_VERSION = 1


def atomic_write(path: pathlib.Path, text: str) -> None:
    """Write-to-temp + atomic rename (same guarantee the simcache uses)."""
    path.parent.mkdir(parents=True, exist_ok=True)
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


def entry_checksum(body: dict) -> str:
    blob = json.dumps({k: v for k, v in body.items() if k != "checksum"},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def grid_key(point_keys) -> str:
    """Digest of a sweep's point-key set (order-independent)."""
    h = hashlib.sha256()
    for k in sorted(point_keys):
        h.update(k.encode())
        h.update(b"\n")
    return h.hexdigest()[:16]


class SweepJournal:
    """Append-only completion journal for one grid of sweep points."""

    def __init__(self, store_root: str | os.PathLike, grid: str):
        self.grid = grid
        self.root = pathlib.Path(store_root) / "journal" / grid
        self.torn = 0           # invalid entries dropped by replay()

    def path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    def exists(self) -> bool:
        return self.root.is_dir()

    def append(self, key: str, meta: dict | None = None) -> None:
        """Record one durably-stored point (atomic per-entry rename)."""
        body = {"schema": SCHEMA_VERSION, "grid": self.grid, "key": key,
                "meta": meta or {}}
        body["checksum"] = entry_checksum(body)
        atomic_write(self.path(key), json.dumps(body, sort_keys=True))

    def replay(self) -> dict[str, dict]:
        """Validated entries as ``{point key: meta}``; torn entries are
        deleted (counted in ``self.torn``) so a resumed sweep recomputes
        exactly the points whose completion never became durable."""
        entries: dict[str, dict] = {}
        if not self.root.is_dir():
            return entries
        for p in sorted(self.root.glob("*.json")):
            try:
                body = json.loads(p.read_text())
                ok = (isinstance(body, dict)
                      and body.get("schema") == SCHEMA_VERSION
                      and body.get("key") == p.stem
                      and body.get("checksum") == entry_checksum(body))
            except (OSError, ValueError):
                ok = False
            if ok:
                entries[p.stem] = body.get("meta", {})
            else:
                self.torn += 1
                try:
                    p.unlink(missing_ok=True)
                except OSError:
                    pass
        return entries

    def complete(self) -> None:
        """Retire the journal after a clean full-grid completion (best
        effort; a concurrent peer completing the same grid is fine)."""
        shutil.rmtree(self.root, ignore_errors=True)

    @staticmethod
    def prune_all(store_root: str | os.PathLike) -> int:
        """Drop every grid journal (store maintenance: pruning the cache
        invalidates resume state too).  Returns directories removed."""
        jroot = pathlib.Path(store_root) / "journal"
        if not jroot.is_dir():
            return 0
        dirs = [p for p in jroot.iterdir() if p.is_dir()]
        for p in dirs:
            shutil.rmtree(p, ignore_errors=True)
        return len(dirs)
