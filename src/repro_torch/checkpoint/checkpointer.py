"""Async, atomic checkpointing of a training state.

The twin of the JAX package's ``checkpoint/checkpointer.py`` for one host:

* **Layout**: one ``host_<id>.npz`` per host per step plus a JSON index
  (``manifest_<id>.json``: shape, dtype and shard count of every leaf),
  keys ``a//b//c`` from the state's paths; an ``nn.Module`` contributes
  its parameter names.  bfloat16 tensors are stored as their ``uint16``
  bits, with ``bfloat16`` named in the index (numpy has no bfloat16).
* **Async**: the device-to-host snapshot is taken on the calling thread
  (a copy, so later in-place updates cannot leak into it); serialization
  runs on a background thread; ``wait()`` joins before the next save.
* **Atomic**: a step is written to ``step_<n>.tmp`` and renamed when
  complete, so a crash mid-save never corrupts the latest checkpoint.
* **Restore** copies into the tensors of a target state of the same
  structure, on their own devices, and returns it.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch import nn

_SEP = "//"


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


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy copy of the leaf's data, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.array(leaf)
    return a, a.dtype.name


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, *, host_id: int = 0,
                 keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Write every leaf of ``tree`` (async by default)."""
        self.wait()
        host_data = {key: _to_host(leaf)
                     for key, leaf in _flatten(tree).items()}

        def _write():
            tmp = self.dir / f"step_{step}.tmp"
            tmp.mkdir(parents=True, exist_ok=True)
            manifest = {key: {"shape": list(data.shape), "dtype": dtype,
                              "n_shards": 1, "index_0": None}
                        for key, (data, dtype) in host_data.items()}
            np.savez(tmp / f"host_{self.host_id}.npz",
                     **{f"{key}{_SEP}0": data
                        for key, (data, _) in host_data.items()})
            (tmp / f"manifest_{self.host_id}.json").write_text(
                json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                      # atomic publish
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

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
        store = np.load(d / f"host_{self.host_id}.npz")
        manifest = json.loads(
            (d / f"manifest_{self.host_id}.json").read_text())

        def load(key: str, like):
            entry = manifest[key]
            data = store[f"{key}{_SEP}0"]
            if isinstance(like, torch.Tensor):
                if entry["dtype"] == "bfloat16":
                    t = torch.from_numpy(data.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(data)
                if t.shape != like.shape or t.dtype != like.dtype:
                    raise ValueError(f"{key}: checkpoint {tuple(t.shape)} "
                                     f"{t.dtype} != target "
                                     f"{tuple(like.shape)} {like.dtype}")
                with torch.no_grad():
                    like.copy_(t)
                return like
            return data.item() if data.shape == () else data

        return _rebuild(target, "", load)


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
