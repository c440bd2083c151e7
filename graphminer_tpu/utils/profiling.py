"""Profiling / tracing utilities.

Parity: include/timer.h (Timer + TIME_OP), the per-phase timer arrays
(fsm/omp_base.cc timers[0..5]), and the per-set-op accumulated counters
(common.h:72-74 time_ops[OP_INTERSECT/...], intersect.cc galloping/merge call
counters). Device additions: a jax.profiler trace context for XLA-level traces.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional


class Timer:
    """Accumulating wall-clock timer (timer.h:6-44)."""

    def __init__(self):
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        self.total += time.perf_counter() - self._t0
        self._t0 = None
        return self.total

    @property
    def seconds(self) -> float:
        return self.total


class Profiler:
    """Named phase timers + op counters; one per run/session."""

    def __init__(self):
        self.timers: Dict[str, Timer] = defaultdict(Timer)
        self.counters: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t = self.timers[name]
        t.start()
        try:
            yield
        finally:
            t.stop()

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def report(self) -> Dict:
        return {
            "phases_s": {k: round(v.total, 6) for k, v in self.timers.items()},
            "counters": dict(self.counters),
        }

    def dump(self) -> str:
        return json.dumps(self.report(), sort_keys=True)


# process-wide default profiler (opt-in; hot paths don't touch it unless
# callers pass it down)
PROFILER = Profiler()


@contextlib.contextmanager
def xla_trace(logdir: str):
    """jax profiler trace around a region — the nvprof/-lineinfo analogue
    (common.mk:43-45,98). View with tensorboard or xprof."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
