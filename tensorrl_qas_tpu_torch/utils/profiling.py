"""Tracing / profiling hooks.

The port's twin of the JAX package's ``utils/profiling.py``.  The
reference's observability is wall-clock appends per step
(``TensorRL_fixed_noiseless.py:107,143,155``) and scipy nfev counts.  Here:
a lightweight phase timer for host-side breakdowns (``PhaseTimer``, the
same summary schema), and opt-in device tracing by ``torch.profiler``
(``TRLQAS_PROFILE=<dir>`` writes a Chrome trace of the wrapped region into
``<dir>``, viewable in Perfetto or ``chrome://tracing``; a PhaseTimer's
phases appear in it as named ranges).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class PhaseTimer:
    """Accumulates wall-clock per named phase (host-side breakdown)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
                for k, v in sorted(self.totals.items())}


@contextlib.contextmanager
def maybe_device_trace():
    """Trace the wrapped region with ``torch.profiler`` when TRLQAS_PROFILE
    names a directory, else do nothing (yields None).

    The trace records CPU activity, and CUDA activity where a card is
    present.  On exit it writes ``<dir>/trace_<pid>_<n>.json`` (Chrome
    trace format) and sets the yielded profiler's ``trace_path`` to it."""
    trace_dir = os.environ.get("TRLQAS_PROFILE")
    if not trace_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(
            trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)
