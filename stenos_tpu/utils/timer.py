"""Nanosecond monotonic timer — stenos_timer parity (stenos.h:258-288,
timer.hpp:49-132) plus a jax.profiler trace helper for kernel-level timing.
"""

import contextlib
import time


class Timer:
    """tick()/tock() nanosecond timer (monotonic)."""

    def __init__(self):
        self._t0 = time.perf_counter_ns()

    def tick(self) -> None:
        self._t0 = time.perf_counter_ns()

    def tock(self) -> int:
        return time.perf_counter_ns() - self._t0


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Wrap a region in a jax.profiler trace (TensorBoard-compatible) —
    the device-side observability counterpart of the reference's bench
    timer."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
