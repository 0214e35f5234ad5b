"""Per-launch timing and profiler hooks.

``Timer`` feeds the ``antidote_device_launch_seconds`` histogram;
``trace_span`` wraps a block in ``torch.profiler.record_function``, so the
span shows up by name in a ``torch.profiler`` trace, and times it into a
histogram.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Timer:
    """Context manager: measure a block, optionally feed a histogram."""

    def __init__(self, histogram=None):
        self.histogram = histogram
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.histogram is not None:
            self.histogram.observe(self.elapsed)
        return False


@contextlib.contextmanager
def trace_span(name: str, histogram=None):
    """Named span: shows up in a ``torch.profiler`` trace and in
    ``histogram`` when one is given."""
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if histogram is not None:
            histogram.observe(time.perf_counter() - t0)
