"""Synthetic LM data pipeline with runahead prefetch.

The twin of the JAX package's ``data/pipeline.py``.  The loader is the
host-side instance of the paper's runahead idea: batch ``step + k``
(k <= depth) is made and copied to the card while step ``step`` computes.
Every batch is a pure function of (seed, step), so checkpoint recovery
replays the identical data order with no loader state to persist.
:func:`device_put` is the loader's ``put_fn`` for the card: pinned host
memory, asynchronous copies on a side stream.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.types import ModelConfig, ShapeConfig


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int,
                    step: int) -> dict[str, np.ndarray]:
    """Zipf-distributed token ids (vocab access is power-law in practice —
    the 'irregular but some locality' regime of the paper's Fig. 7)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        t = min(cfg.decoder_len, s)
        return {
            "frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
            "dec_tokens": rng.integers(0, cfg.vocab_size, (b, t), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, t), dtype=np.int32),
        }
    tokens = (rng.zipf(1.3, size=(b, s)) % cfg.vocab_size).astype(np.int32)
    batch: dict[str, np.ndarray] = {}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = tokens
    batch["labels"] = np.roll(tokens, -1, axis=1)
    return batch


def device_put(device) -> Callable[[dict], dict]:
    """A ``put_fn`` that moves a host batch to ``device``.  On the card each
    array is pinned and copied with ``non_blocking=True`` on a side stream;
    the function returns once its copies are done, so the loader's worker
    thread, not the training stream, waits for them.  The tensors are
    marked as used on the stream that is current here, so their memory is
    not reused before that stream's kernels have read them."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: {k: torch.from_numpy(np.array(v)).to(device)
                              for k, v in batch.items()}
    consumer = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)

    def put(batch: dict) -> dict:
        out = {}
        with torch.cuda.stream(side):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = host.to(device, non_blocking=True)
                out[k].record_stream(consumer)
        side.synchronize()
        return out

    return put


@dataclasses.dataclass
class RunaheadLoader:
    """Prefetching loader: keeps ``depth`` future batches in flight."""

    batch_fn: Callable[[int], Any]          # step -> host batch
    put_fn: Callable[[Any], Any] | None = None  # host batch -> device arrays
    depth: int = 2

    def __post_init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._inflight: dict[int, concurrent.futures.Future] = {}

    def _submit(self, step: int) -> None:
        if step not in self._inflight:
            def make(s=step):
                b = self.batch_fn(s)
                return self.put_fn(b) if self.put_fn else b
            self._inflight[step] = self._pool.submit(make)

    def get(self, step: int) -> Any:
        """Batch for ``step``; issues prefetches for the runahead window."""
        self._submit(step)
        for k in range(1, self.depth + 1):
            self._submit(step + k)
        fut = self._inflight.pop(step)
        # drop stale entries (e.g. after a restart rewinds the step counter)
        for s in [s for s in self._inflight if s < step]:
            self._inflight.pop(s)
        return fut.result()

    def close(self) -> None:
        self._pool.shutdown(wait=False)
