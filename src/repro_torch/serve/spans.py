"""Named host spans of the serve engine, on ``torch.profiler``'s timeline.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler collects, and one shared null context otherwise.  The spans are
profiler events, so they land in the profiler's trace beside the kernels
and on the same clock; with no profiler running a span costs one check of
the profiler's state and never enters ``record_function``.
"""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
