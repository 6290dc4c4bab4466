"""Continuous-batching serving engine over a paged KV cache (PyTorch port).

The twin of ``repro.serve``: a global physical page pool (:mod:`paging`)
replaces per-request KV allocations; a slot scheduler (:mod:`scheduler`)
composes every step's batch from whatever sequences are live; the engine
(:mod:`engine`) drives the fixed-shape decode / chunked-prefill steps built
by :func:`repro_torch.launch.steps.build_serve_engine_steps`, whose decode
attention reads the page pool through the CUDA paged-attention kernel.
"""
from .engine import Backpressure, ServeEngine          # noqa: F401
from .loadgen import drive, poisson_workload           # noqa: F401
from .paging import PagePool, PoolExhausted            # noqa: F401
from .scheduler import (Request, RequestState,          # noqa: F401
                        SamplingParams, Scheduler)
