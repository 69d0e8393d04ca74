"""Profiling hooks: trace annotations and throughput counters.

The reference has no profiling instrumentation (SURVEY.md §5); these wrap
``jax.profiler`` so hot sections show up named in TensorBoard/XProf traces.
"""

import contextlib
import time

import jax


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in the device trace (jax.profiler.TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a full profiler trace into ``logdir`` (view with xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Throughput:
    """Wall-clock env-steps/s counter with warm-up exclusion.

    Dispatch is asynchronous: the caller must wait for the device
    (``jax.block_until_ready``) before reading ``steps_per_s``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = None
        self._steps = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def add(self, n_steps: int):
        self._steps += n_steps

    @property
    def steps_per_s(self):
        if self._t0 is None or self._steps == 0:
            return 0.0
        return self._steps / (time.perf_counter() - self._t0)
