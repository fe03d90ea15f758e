"""Tracing / profiling — the Timer.zig + Stats.zig plotting analog.

The reference measures only CPU wall-clock per frame (Timer.zig:19-28)
and plots a 100-frame history in the UI (Stats.zig:129-134).  This
build goes further (SURVEY.md §5 mandates the mapping):

- ``trace(path)``: context manager around ``jax.profiler`` producing a
  TensorBoard-loadable device trace of the wavefront kernels.
- ``annotate(name)``: TraceAnnotation for host-side phases (scene
  load, BVH build, PNG write) so they interleave with device events.
- ``FrameProfiler``: per-phase wall timing with an EMA + history ring
  buffer, used by the driver's --profile mode.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace into log_dir (TensorBoard format)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host annotation that shows up inside profiler traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)


class FrameProfiler:
    """Wall-clock per named phase, with history (Stats.zig ring-buffer
    analog, headless)."""

    def __init__(self, history: int = 100):
        self.history: Dict[str, collections.deque] = {}
        self._maxlen = history
        self._open: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.history.setdefault(
                name, collections.deque(maxlen=self._maxlen)
            ).append(dt)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, hist in self.history.items():
            vals = list(hist)
            out[name] = {
                "count": len(vals),
                "last_ms": round(vals[-1] * 1000.0, 3),
                "mean_ms": round(sum(vals) / len(vals) * 1000.0, 3),
                "min_ms": round(min(vals) * 1000.0, 3),
                "max_ms": round(max(vals) * 1000.0, 3),
            }
        return out
