"""Named host spans on the search path, for ``torch.profiler`` traces.

``span(name)`` is a ``record_function`` range while a profiler is
recording and one shared no-op context otherwise, so an untraced call pays
a flag read a span.  Every name starts with ``repro_torch.``, which tells
the program's spans from aten ops and from a caller's own ranges in a
trace.  The profiler keeps the spans in memory and writes them out with
the kernels and copies when it stops, on one clock.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range under a recording profiler, else a
    shared ``nullcontext``."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
