"""Per-launch timing hooks.

``Timer`` feeds the ``antidote_device_launch_seconds`` histogram;
``trace_span`` times a named block into a histogram.  Annotating the span
in a ``torch.profiler`` trace is not ported yet: here it is a plain timer.
"""

from __future__ import annotations

import contextlib
import time


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
    """Named span: its wall time lands in ``histogram`` when one is
    given.  ``name`` labels the span for the profiler annotation."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if histogram is not None:
            histogram.observe(time.perf_counter() - t0)
