"""Profiling & throughput instrumentation.

The reference only prints per-epoch timings (SURVEY.md §6 "Tracing /
profiling: absent"); the rebuild ships (a) ``jax.profiler`` trace capture
around any code region and (b) a lightweight throughput meter that waits for
the device (``jax.block_until_ready``) at its measure points, so it times the
work and not the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import jax


@contextlib.contextmanager
def trace(logdir: str, *, enabled: bool = True):
    """Capture a jax.profiler trace viewable in TensorBoard/XProf.

    Usage::
        with profiling.trace("/tmp/trace"):
            run_steps()
    """
    if not enabled:
        yield
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(x) -> None:
    """Wait until every array of the pytree ``x`` has been computed."""
    jax.block_until_ready(x)


class ThroughputMeter:
    """Streaming items/sec with device synchronization at measure points.

    Mirrors the per-epoch 'images/sec' printouts of the reference's training
    loops.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._items = 0
        self._t0 = None

    def start(self, sync_on=None) -> None:
        if sync_on is not None:
            sync(sync_on)
        self._t0 = time.perf_counter()
        self._items = 0

    def add(self, n: int) -> None:
        self._items += n

    def stop(self, sync_on=None) -> float:
        """Returns items/sec since start()."""
        if sync_on is not None:
            sync(sync_on)
        dt = time.perf_counter() - self._t0
        return self._items / dt if dt > 0 else float("inf")
