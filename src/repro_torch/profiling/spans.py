"""Named ranges of the program in the profiler's CPU trace.

``span(name)`` is the one way the program opens a range:

* with no profiler running it returns a shared null context, so the hot
  path pays one flag check and makes no ``RecordFunction``;
* under ``torch.profiler`` it opens a ``RecordFunction`` of function
  scope, not a user annotation: the operators run inside it take it as
  their ``cpu_parent``, and Kineto puts no copy of it on the device
  timeline (``torch.profiler.record_function`` opens a user annotation,
  which the trace repeats as a device event that covers the range's
  kernels and the gaps between them).

The range shares the profiler's clock with the device events, so a
reader of the trace can sum the kernels launched inside it and put the
device's idle gaps down to what the host was doing.  Span names are
module constants of the code that opens them.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the profiler's CPU trace while a
    profiler runs, and does nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
