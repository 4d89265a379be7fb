"""Profiling hooks: ``torch.profiler`` traces and wall-clock stage timers.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/utils/profiling.py``:
``stage_timer`` records wall-clock seconds per stage into a dict (waiting for
the device at exit, see ``utils.timing.force_sync``), and ``trace`` captures
a host and CUDA profile as a Chrome trace (Perfetto, ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from .timing import force_sync


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where there is a card) and write the Chrome trace
    to ``<log_dir>/trace.json``.  Yields the ``torch.profiler.profile``, whose
    ``key_averages()`` sums the time by operator and kernel."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def stage_timer(timings: dict, name: str, sync_on=None):
    """Record wall-clock seconds for a stage into ``timings[name]``.

    Args:
        timings: dict to write into.
        name: stage key.
        sync_on: optional tensor or tree of tensors whose devices are
            synchronized before the clock stops.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_on is not None:
            force_sync(sync_on)
        timings[name] = time.perf_counter() - t0
