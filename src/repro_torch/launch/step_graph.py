"""CUDA-graph replay of the serve engine's fixed-shape model steps.

The continuous-batching engine runs two step kinds at shapes fixed when
it is built: the decode step over every slot and the prefill chunk of one
slot.  Each kind's model half (:func:`repro_torch.models.paged_lm.
serve_decode_logits`, :func:`~repro_torch.models.paged_lm.
serve_prefill_logits`) issues one fixed sequence of kernels whatever the
batch holds: what the host decides arrives as small input tensors and in
the cache's ``lengths`` / ``page_table`` tensors, which the engine
overwrites in place before every step.  :class:`StepGraph` runs such a
function eagerly on its first call, so that kernel builds, library loads
and cuBLAS handles happen outside any capture, captures it as a CUDA
graph on its second and replays that graph on every later call, its
inputs first copied into the graph's static buffers.  Issued op by op
from Python, a full-width MoE decode step is ~1,700 launches of host
time; a replay is one.

A graph is keyed on the params and cache objects it captured: a call with
others captures anew and never replays a stale graph.  The returned
tensor is the graph's static output, overwritten by the next replay.

The kernels' launch counters (``.launches``) are Python attributes that
a replay does not touch; each replay adds the launches its capture
counted, so they go on counting kernels run.  A ``torch.profiler`` trace
started after the capture still lists each replayed kernel under its
name, correlated to the step's ``cudaGraphLaunch``.
"""
from __future__ import annotations

import torch


def _counters() -> list:
    """The wrappers of the kernels the serve steps launch, whose
    ``launches`` attributes count their launches."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe
    from repro_torch.kernels.paged_attention import paged_attention as pa
    return [pa.paged_attention, moe.dispatch, moe.combine]


class StepGraph:
    """``forward(params, *inputs, cache) -> tensor``, replayed as a CUDA
    graph from its second call on.

    ``dtypes`` gives the device dtype of each of ``inputs`` (host arrays,
    numbers or tensors of a fixed shape).  ``pool`` is the memory pool
    handle the graph's temporaries live in, shared by graphs that never
    run at once.  ``replays`` counts the calls that ran as a replay."""

    def __init__(self, forward, dtypes: tuple, pool):
        self.forward = forward
        self.dtypes = dtypes
        self.pool = pool
        self.calls = 0
        self.replays = 0
        self._graph = None
        self._key = None

    def __call__(self, params, *inputs, cache):
        self.calls += 1
        if self.calls == 1:
            return self.forward(params, *inputs, cache)
        fresh = (self._key is None or self._key[0] is not params
                 or self._key[1] is not cache)
        if fresh:
            self._inputs = [
                torch.empty(torch.as_tensor(x).shape, dtype=dt,
                            device=cache["lengths"].device)
                for x, dt in zip(inputs, self.dtypes)]
        for buf, x in zip(self._inputs, inputs):
            buf.copy_(torch.as_tensor(x))
        if fresh:
            self._capture(params, cache)
        else:
            for fn, n in zip(_counters(), self._launches):
                fn.launches += n
        self._graph.replay()
        self.replays += 1
        return self._out

    def _capture(self, params, cache) -> None:
        """Capture ``forward`` on the static input buffers.  The capture
        runs nothing, but the wrappers' counters move all the same: those
        counts stand for the replay that follows it."""
        self._graph = self._out = self._key = None
        graph = torch.cuda.CUDAGraph()
        before = [fn.launches for fn in _counters()]
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = self.forward(params, *self._inputs, cache)
        self._launches = [fn.launches - n
                          for fn, n in zip(_counters(), before)]
        self._graph, self._out, self._key = graph, out, (params, cache)
