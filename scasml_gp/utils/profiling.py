"""Profiling utilities: wall-clock timers + jax.profiler traces.

Replaces the reference's cProfile wrapping of every harness
(tests/SimpleUniform.py:57-58,143-149) with device-aware timing
(block_until_ready) and optional XLA/perfetto traces."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class Timer:
    """Accumulating wall-clock timer that waits for device completion."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.times[name] = self.times.get(name, 0.0) + elapsed

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, block on its device outputs, record elapsed seconds."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        out = jax.block_until_ready(out)
        self.times[name] = self.times.get(name, 0.0) + (
            time.perf_counter() - start
        )
        return out


@contextlib.contextmanager
def xla_trace(log_dir: Optional[str]):
    """jax.profiler trace (perfetto) when a directory is given; no-op otherwise."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def harness_profile(profile_dir: Optional[str], tag: str):
    """Per-harness profiling artifact (reference tests/SimpleUniform.py:57-58,
    143-149 wraps every harness in cProfile and dumps ``<eq>_rho_<r>.prof``).

    Emits BOTH a host-side cProfile dump (``<profile_dir>/<tag>.prof``) and a
    device-side XLA/perfetto trace in the same directory — the host profile
    alone is blind to where device time goes. No-op when
    ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    import cProfile
    import os

    os.makedirs(profile_dir, exist_ok=True)
    prof = cProfile.Profile()
    prof.enable()
    try:
        with jax.profiler.trace(profile_dir):
            yield
    finally:
        prof.disable()
        prof.dump_stats(os.path.join(profile_dir, f"{tag}.prof"))
