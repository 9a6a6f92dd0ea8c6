"""Profiling hooks of the port (counterpart of
``mvlt_tpu/utils/profiling.py``), on ``torch.profiler``.

- :func:`trace` records the calls inside it, host and device (CPU and, where
  a card is present, CUDA activities), and writes one Chrome trace file,
  ``trace.json``, under ``log_dir`` (JAX's ``jax.profiler`` trace, for
  Perfetto or ``chrome://tracing``).
- :func:`annotate` names a range: a ``record_function`` span in such a
  trace and, on a card, an NVTX range for an outside profiler.
- :class:`StepTimer` times a step on the host clock; ``stop(value)`` first
  waits for the device when ``value`` is a tensor on a card (JAX fetches
  the value to the host for the same reason).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the calls inside and write ``log_dir/trace.json``. Yields the
    profiler (its ``key_averages()`` after the block)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: ``record_function`` (a span of :func:`trace`) and, on
    a card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Host-clock timer of a step; ``stop(sync_value)`` synchronises the
    device of ``sync_value`` first when it is a tensor on a card, so that
    the time covers the step's kernels."""

    def __init__(self):
        self.t0: Optional[float] = None

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        assert self.t0 is not None, "StepTimer.stop before start"
        return time.perf_counter() - self.t0
