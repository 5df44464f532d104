"""Stage timing + profiling.

First-class replacement for the reference's ad-hoc pcl::ScopeTime RAII
timers (src/registration_visualisation.cpp:51-158): a stage timer that
blocks on device results (so on-device time is actually counted) and an
optional jax.profiler trace context (SURVEY.md §5 tracing plan). JAX
returns before the device finishes; every timing here ends in
jax.block_until_ready.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import jax


class StageTimes:
    """Collects named stage wall-clock times."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result_holder: list | None = None):
        t0 = time.perf_counter()
        yield
        if result_holder:
            jax.block_until_ready(result_holder)
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        print(f"[stage] {name}: {dt * 1000.0:.1f} ms", flush=True)

    def block(self, value: Any) -> Any:
        """Block on a pytree so the enclosing stage measures device time."""
        return jax.block_until_ready(value)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """jax.profiler trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield
