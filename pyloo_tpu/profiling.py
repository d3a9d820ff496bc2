"""Profiling and throughput instrumentation.

The reference has no tracing/profiling subsystem (SURVEY.md §5); this module
is the accelerator-native equivalent: ``trace`` wraps ``jax.profiler`` for
TensorBoard-viewable device traces, and ``Throughput`` measures synchronized
wall-clock rates (observations/sec) around device work.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import jax

__all__ = ["trace", "Throughput", "annotate"]


@contextmanager
def trace(log_dir: str):
    """Capture a device profile into ``log_dir`` (open with TensorBoard).

    >>> with trace("/tmp/jax-trace"):
    ...     loo(idata)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in profiler traces (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


@dataclass
class Throughput:
    """Synchronized throughput counter.

    >>> meter = Throughput()
    >>> with meter.measure(n_items=batch.shape[0]):
    ...     out = kernel(batch)
    ...     jax.block_until_ready(out)
    >>> meter.items_per_sec
    """

    total_items: int = 0
    total_seconds: float = 0.0
    laps: list = field(default_factory=list)

    @contextmanager
    def measure(self, n_items: int):
        start = time.perf_counter()
        yield
        elapsed = time.perf_counter() - start
        self.total_items += n_items
        self.total_seconds += elapsed
        self.laps.append((n_items, elapsed))

    @property
    def items_per_sec(self) -> float:
        if self.total_seconds == 0:
            return 0.0
        return self.total_items / self.total_seconds

    def summary(self, unit: str = "obs") -> str:
        return (
            f"{self.total_items} {unit} in {self.total_seconds:.3f}s "
            f"({self.items_per_sec:,.0f} {unit}/s over {len(self.laps)} laps)"
        )
