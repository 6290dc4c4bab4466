"""Async, atomic checkpointing of a training state.

The twin of the JAX package's ``checkpoint/checkpointer.py``:

* **Layout**: one ``host_<id>.npz`` per host (rank) per step plus a JSON
  index (``manifest_<id>.json``: global shape, dtype, shard count and each
  shard's ``[start, stop, 1]`` box of every leaf), keys ``a//b//c`` from
  the state's paths; an ``nn.Module`` contributes its parameter names.  A
  plain tensor is one whole shard (box ``None``); a DTensor contributes
  the rank's local shard at its global offsets.  bfloat16 tensors are
  stored as their ``uint16`` bits, with ``bfloat16`` named in the index
  (numpy has no bfloat16).
* **Async**: the device-to-host snapshot is taken on the calling thread
  (a copy, so later in-place updates cannot leak into it); serialization
  runs on a background thread; ``wait()`` joins before the next save.
* **Atomic**: a step is written to ``step_<n>.tmp`` and renamed when
  every host's files are written (``n_hosts`` > 1: each host leaves a
  marker, host 0 renames, the others wait for the rename), so a crash
  mid-save never corrupts the latest checkpoint.
* **Restore** copies into the tensors of a target state of the same
  structure, on their own devices, and returns it.  A DTensor target is
  filled shard by shard from whatever boxes the checkpoint holds, so a
  state saved on one mesh restores onto any other.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import local_box

_SEP = "//"
PUBLISH_TIMEOUT_S = 600.0


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, nn.Module):
        return {f"{prefix}{name.replace('.', _SEP)}": p
                for name, p in tree.named_parameters()}
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return flat
    if isinstance(tree, (list, tuple)):
        flat = {}
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}{_SEP}"))
        return flat
    return {prefix[:-len(_SEP)]: tree}


def _box(leaf):
    """The leaf's (global shape, this host's box): a DTensor's local shard
    box, ``None`` for a whole tensor."""
    if isinstance(leaf, DTensor):
        box = local_box(leaf.shape, leaf.device_mesh, leaf.placements)
        return list(leaf.shape), [[a, b, 1] for a, b in box]
    return None, None


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy copy of the leaf's data, its dtype's name); a DTensor's
    local shard."""
    if isinstance(leaf, DTensor):
        leaf = leaf.to_local()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf)
    return a, a.dtype.name


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, *, host_id: int = 0,
                 n_hosts: int = 1, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Write every leaf of ``tree`` (async by default)."""
        self.wait()
        host_data = {key: (*_to_host(leaf), *_box(leaf))
                     for key, leaf in _flatten(tree).items()}

        def _write():
            tmp = self.dir / f"step_{step}.tmp"
            tmp.mkdir(parents=True, exist_ok=True)
            manifest = {key: {"shape": shape or list(data.shape),
                              "dtype": dtype, "n_shards": 1, "index_0": box}
                        for key, (data, dtype, shape, box)
                        in host_data.items()}
            np.savez(tmp / f"host_{self.host_id}.npz",
                     **{f"{key}{_SEP}0": data
                        for key, (data, *_) in host_data.items()})
            (tmp / f"manifest_{self.host_id}.json").write_text(
                json.dumps(manifest))
            self._publish(step, tmp)

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _publish(self, step: int, tmp: pathlib.Path) -> None:
        """Rename ``tmp`` to ``step_<step>`` once every host wrote it."""
        final = self.dir / f"step_{step}"
        if self.n_hosts > 1:
            (tmp / f"done_{self.host_id}").touch()
            deadline = time.monotonic() + PUBLISH_TIMEOUT_S
            if self.host_id != 0:
                while tmp.exists() or not final.exists():
                    _wait_until(deadline, f"step {step} publish")
                return
            while len(list(tmp.glob("done_*"))) < self.n_hosts:
                _wait_until(deadline, f"step {step}: all hosts' shards")
            for marker in tmp.glob("done_*"):
                marker.unlink()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                          # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp")
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> Any:
        """Load step ``step`` into ``target`` (a state of the same
        structure): tensors are overwritten in place on their devices,
        other leaves replaced.  Returns the restored state."""
        self.wait()
        d = self.dir / f"step_{step}"
        hosts = sorted(int(p.stem.split("_")[1])
                       for p in d.glob("manifest_*.json"))
        stores = [np.load(d / f"host_{h}.npz") for h in hosts]
        manifests = [json.loads((d / f"manifest_{h}.json").read_text())
                     for h in hosts]

        def load(key: str, like):
            entry = manifests[0][key]
            if not isinstance(like, torch.Tensor):
                data = stores[0][f"{key}{_SEP}0"]
                return data.item() if data.shape == () else data
            shape, dt = tuple(entry["shape"]), getattr(torch, entry["dtype"])
            if shape != tuple(like.shape) or dt != like.dtype:
                raise ValueError(f"{key}: checkpoint {shape} {dt} != "
                                 f"target {tuple(like.shape)} {like.dtype}")
            box = ([(0, n) for n in shape] if not isinstance(like, DTensor)
                   else local_box(shape, like.device_mesh, like.placements))
            out = torch.empty([b - a for a, b in box], dtype=dt)
            for store, mf in zip(stores, manifests):
                for i in range(mf[key]["n_shards"]):
                    _paste(out, box, _tensor(store[f"{key}{_SEP}{i}"], dt),
                           mf[key][f"index_{i}"])
            with torch.no_grad():
                (like.to_local() if isinstance(like, DTensor)
                 else like).copy_(out)
            return like

        return _rebuild(target, "", load)


def _tensor(data: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    if dt == torch.bfloat16:
        return torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(data)


def _paste(out: torch.Tensor, box, shard: torch.Tensor, index) -> None:
    """Copy the part of ``shard`` (at ``index``: [start, stop, 1] a dim, or
    None for the whole tensor) that falls in ``box`` into ``out``."""
    if index is None:
        index = [[0, n, 1] for n in shard.shape]
    dst, src = [], []
    for (a, b), (s0, s1, _) in zip(box, index):
        lo, hi = max(a, s0), min(b, s1)
        if lo >= hi:
            return
        dst.append(slice(lo - a, hi - a))
        src.append(slice(lo - s0, hi - s0))
    out[tuple(dst)] = shard[tuple(src)]


def _wait_until(deadline: float, what: str) -> None:
    if time.monotonic() > deadline:
        raise TimeoutError(f"checkpoint: timed out waiting for {what}")
    time.sleep(0.01)


def _rebuild(tree: Any, prefix: str, load) -> Any:
    if isinstance(tree, nn.Module):
        for key, p in _flatten(tree, prefix).items():
            load(key, p)
        return tree
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}{k}{_SEP}", load)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, f"{prefix}{i}{_SEP}", load)
                          for i, v in enumerate(tree))
    return load(prefix[:-len(_SEP)], tree)
